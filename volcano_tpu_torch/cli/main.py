"""vtpuctl: job and queue management CLI.

Command surface mirrors vcctl (cmd/cli/job.go:11-67, cmd/cli/queue.go):

  vtpuctl job run|list|view|suspend|resume|delete
  vtpuctl queue create|list|delete|operate

Talks JSON/HTTP to a running framework Service
(``python -m volcano_tpu_torch.service``), the way vcctl talks to the API
server.  ``vtpuctl job run -f job.yaml`` accepts a YAML job spec; flags
cover the quick path (vsub-style).

No YAML library: job files go through the port's own YAML subset reader
(``framework.conf.load_yaml``, which reads what ``yaml.safe_load`` reads on
that subset and raises with the line number past it), and ``job view``
prints through ``cli.emit.safe_dump`` (``yaml.safe_dump(sort_keys=False)``'s
text for the API's JSON values).  Run as ``python -m volcano_tpu_torch.cli``.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.error
import urllib.request

from ..framework.conf import load_yaml
from .emit import safe_dump

DEFAULT_SERVER = "http://127.0.0.1:11250"


def _request(server: str, method: str, path: str, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        server + path, data=data, method=method,
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as err:
        payload = err.read().decode()
        try:
            message = json.loads(payload).get("error", payload)
        except Exception:
            message = payload
        print(f"Error: {message}", file=sys.stderr)
        sys.exit(1)
    except urllib.error.URLError as err:
        print(f"Error: cannot reach server {server}: {err.reason}",
              file=sys.stderr)
        sys.exit(1)


# ------------------------------------------------------------------ job cmds


def job_run(args):
    if args.filename:
        with open(args.filename) as f:
            try:
                spec = load_yaml(f.read(), what=args.filename)
            except ValueError as err:
                print(f"Error: {err}", file=sys.stderr)
                sys.exit(1)
    else:
        if not args.name:
            print("Error: --name or -f required", file=sys.stderr)
            sys.exit(1)
        spec = {
            "name": args.name,
            "namespace": args.namespace,
            "minAvailable": args.min_available or args.replicas,
            "queue": args.queue,
            "tasks": [
                {
                    "name": "default",
                    "replicas": args.replicas,
                    "containers": [
                        {"cpu": args.cpu, "memory": args.memory}
                    ],
                }
            ],
        }
    out = _request(args.server, "POST", "/apis/jobs", spec)
    print(f"run job {out['namespace']}/{out['name']} successfully")


def job_list(args):
    jobs = _request(
        args.server, "GET",
        f"/apis/jobs?namespace={args.namespace}" if args.namespace
        else "/apis/jobs",
    )
    fmt = "{:<12}{:<24}{:<12}{:>8}{:>9}{:>11}{:>8}{:>7}"
    print(fmt.format("Namespace", "Name", "Phase", "Pending", "Running",
                     "Succeeded", "Failed", "Retry"))
    for j in jobs:
        s = j["status"]
        print(fmt.format(j["namespace"], j["name"], s["phase"], s["pending"],
                         s["running"], s["succeeded"], s["failed"],
                         s["retryCount"]))


def job_view(args):
    job = _request(args.server, "GET",
                   f"/apis/jobs/{args.namespace}/{args.name}")
    print(safe_dump(job))


def _job_command(args, action: str, verb: str):
    _request(
        args.server, "POST", "/apis/commands",
        {"action": action, "targetKind": "Job", "targetName": args.name,
         "targetNamespace": args.namespace},
    )
    print(f"{verb} job {args.namespace}/{args.name} successfully")


def job_suspend(args):
    _job_command(args, "AbortJob", "suspend")


def job_resume(args):
    _job_command(args, "ResumeJob", "resume")


def job_delete(args):
    _request(args.server, "DELETE",
             f"/apis/jobs/{args.namespace}/{args.name}")
    print(f"delete job {args.namespace}/{args.name} successfully")


# ---------------------------------------------------------------- queue cmds


def queue_create(args):
    _request(
        args.server, "POST", "/apis/queues",
        {"name": args.name, "weight": args.weight,
         "reclaimable": not args.no_reclaim},
    )
    print(f"create queue {args.name} successfully")


def queue_list(args):
    queues = _request(args.server, "GET", "/apis/queues")
    fmt = "{:<24}{:>8}  {:<10}{:<12}"
    print(fmt.format("Name", "Weight", "State", "Reclaimable"))
    for q in queues:
        print(fmt.format(q["name"], q["weight"], q["state"],
                         str(q["reclaimable"])))


def queue_delete(args):
    _request(args.server, "DELETE", f"/apis/queues/{args.name}")
    print(f"delete queue {args.name} successfully")


def queue_operate(args):
    action = "OpenQueue" if args.action == "open" else "CloseQueue"
    _request(
        args.server, "POST", "/apis/commands",
        {"action": action, "targetKind": "Queue", "targetName": args.name},
    )
    print(f"{args.action} queue {args.name} successfully")


# --------------------------------------------------------------------- parse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vtpuctl",
                                description="volcano-tpu batch CLI")
    p.add_argument("--server", default=DEFAULT_SERVER,
                   help="framework API endpoint")
    sub = p.add_subparsers(dest="group", required=True)

    job = sub.add_parser("job", help="job operations")
    jsub = job.add_subparsers(dest="cmd", required=True)

    run = jsub.add_parser("run", help="submit a job")
    run.add_argument("-f", "--filename", help="YAML job spec")
    run.add_argument("--name")
    run.add_argument("-n", "--namespace", default="default")
    run.add_argument("--queue", default="default")
    run.add_argument("-r", "--replicas", type=int, default=1)
    run.add_argument("--min-available", type=int, default=0)
    run.add_argument("--cpu", default="1")
    run.add_argument("--memory", default="1Gi")
    run.set_defaults(func=job_run)

    lst = jsub.add_parser("list", help="list jobs")
    lst.add_argument("-n", "--namespace", default="")
    lst.set_defaults(func=job_list)

    for name, fn in (("view", job_view), ("suspend", job_suspend),
                     ("resume", job_resume), ("delete", job_delete)):
        c = jsub.add_parser(name)
        c.add_argument("--name", required=True)
        c.add_argument("-n", "--namespace", default="default")
        c.set_defaults(func=fn)

    queue = sub.add_parser("queue", help="queue operations")
    qsub = queue.add_subparsers(dest="cmd", required=True)

    qc = qsub.add_parser("create")
    qc.add_argument("--name", required=True)
    qc.add_argument("--weight", type=int, default=1)
    qc.add_argument("--no-reclaim", action="store_true")
    qc.set_defaults(func=queue_create)

    ql = qsub.add_parser("list")
    ql.set_defaults(func=queue_list)

    qd = qsub.add_parser("delete")
    qd.add_argument("--name", required=True)
    qd.set_defaults(func=queue_delete)

    qo = qsub.add_parser("operate")
    qo.add_argument("--name", required=True)
    qo.add_argument("-a", "--action", choices=["open", "close"],
                    required=True)
    qo.set_defaults(func=queue_operate)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.func(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())


# ---------------------------------------------------------------- v-binaries
# Standalone entry points mirroring the reference's vsub/vjobs/vqueues/
# vcancel/vsuspend/vresume binaries (cmd/cli/ subdirs): each is the
# corresponding subcommand with the same flags.

def _shim(prefix):
    def entry(argv=None):
        args = list(sys.argv[1:] if argv is None else argv)
        # --server is a root-parser flag: lift it in front of the
        # injected subcommand; everything else stays behind it.
        pre, rest = [], []
        i = 0
        while i < len(args):
            a = args[i]
            if a == "--server" and i + 1 < len(args):
                pre.extend(args[i:i + 2])
                i += 2
                continue
            if a.startswith("--server="):
                pre.append(a)
            else:
                rest.append(a)
            i += 1
        return main(pre + prefix + rest)

    return entry


vsub = _shim(["job", "run"])
vjobs = _shim(["job", "list"])
vcancel = _shim(["job", "delete"])
vsuspend = _shim(["job", "suspend"])
vresume = _shim(["job", "resume"])
vqueues = _shim(["queue", "list"])
