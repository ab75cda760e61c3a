"""The port's admission, CLI and YAML handling against the JAX package's.

Twins of ``tests/test_admission_table.py`` and ``test_admission_cli.py``:
each of their test functions, methods and parametrized cases runs against
both packages (``test_torch_fixtures.run_twin_case``: the module as
written, then pointed at the port), its own assertions holding on each and
the store's control digest after every pump equal.  The service / CLI
classes of ``test_admission_cli.py`` order their threads with sleeps; their
twins here drive each package's service step by step instead
(``test_torch_fixtures.PumpedService``: the HTTP API on a free loopback
port, the loops not started): the same CLI verbs against both, the
printed output equal byte for byte once the event trails' wall-clock
stamps are masked, and the port's ``job view`` equal to
``yaml.safe_dump(sort_keys=False)`` of what the API returned.

The port carries no YAML library: ``framework.conf.load_yaml`` must read
every file of ``examples/`` to what ``yaml.safe_load`` gives, and
``cli.emit.safe_dump`` write what ``yaml.safe_dump`` writes for seeded
random JSON documents (PyYAML, which this host has, is the reference
only).  The CLI also runs in a child process in which ``import yaml``
fails.
"""

import contextlib
import io
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

import volcano_tpu
import volcano_tpu_torch
from test_torch_fixtures import (PumpedService, reset_uid_counters,
                                 run_twin_case, twin_cases)
from volcano_tpu_torch.cli.emit import safe_dump
from volcano_tpu_torch.framework.conf import load_yaml

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
PKGS = (volcano_tpu, volcano_tpu_torch)

# Driven step by step below instead: these order threads with sleeps.
THREADED = ("TestServiceAndCli", "TestClientLib.test_client_against_live_service")

CASES = [(m, c) for m in ("test_admission_table.py", "test_admission_cli.py")
         for c in twin_cases(ROOT / m, skip=THREADED)]


@pytest.mark.parametrize("module,case", CASES,
                         ids=[f"{m[5:-3]}::{c}" for m, c in CASES])
def test_jax_admission_case_twin(module, case):
    want = run_twin_case(ROOT / module, case, volcano_tpu)
    got = run_twin_case(ROOT / module, case, volcano_tpu_torch)
    assert got == want


# ------------------------------------------------------------ YAML reader

EXAMPLES = sorted(p.name for p in (REPO / "examples").glob("*.yaml"))


@pytest.mark.parametrize("name", EXAMPLES)
def test_reader_parses_examples_like_pyyaml(name):
    text = (REPO / "examples" / name).read_text()
    assert load_yaml(text) == yaml.safe_load(text)


FLOW = [
    "a: []\n", "a: {}\n", "a: [ ]\n", "a: [x, 'y, z', \"q\", 1, 2.5]\n",
    "a: [true, null, ~, no, 0o7x]\n", "a: [x,]\n",
    "a: {k: 1, 'j': x, m: [} ]x}\n".replace("[} ]x", "'[} ]x'"),
    "a:\n- [1, 2]\n- {b: c}\n- []\n", "- {a: 1}\n- [b]\n",
    "ssh: []  # comment [x]\nsvc: {}\n", "a: ['it''s', \"q\\\"\"]\n",
]


@pytest.mark.parametrize("text", FLOW)
def test_reader_flow_collections_like_pyyaml(text):
    assert load_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: [[1]]\n", 2),  # nested flow collection
    ("a: [1,,2]\n", 1),  # empty entry
    ("a:\n  - 1\n  - [1, 2\n", 3),  # multi-line flow collection
    ("a: {x}\n", 1),  # flow mapping entry without a value
    ("a: &x 1\n", 1),  # anchor
    ("a: |\n  text\n", 1),  # block scalar
    ("x: 1\n[a]\n", 2),  # flow collection as a node of its own
])
def test_reader_refuses_with_line_number(text, line):
    with pytest.raises(ValueError, match=rf"line {line}:"):
        load_yaml(text, what="job.yaml")


def test_conf_reader_still_refuses_flow_collections():
    """The scheduler conf keeps its narrower subset."""
    from volcano_tpu_torch.framework.conf import parse_scheduler_conf

    for text in ("actions: {a: 1}\n", "tiers: [a, b]\n"):
        with pytest.raises(ValueError, match="scheduler conf line 1"):
            parse_scheduler_conf(text)


# --------------------------------------------------------------- emitter

_ALPHABET = (
    "abcXYZ019 :-#,'\"[]{}&*!|>%@`?.\n_/=~<\x85\u00e9\u2028\x00\t")
_WORDS = ["yes", "No", "null", "~", "1", "0x1F", "1.5", ".inf", "1e5",
          "2020-01-01", "=", "<<", "", " a", "a ", "- x", "a: b", "a #b",
          "#x", "---", "true", "012", "1_000", "1:20", "-", "?", ":x",
          "Successfully assigned default/test-job-worker-0 to n0"]


def _random_doc(rng):
    def text():
        r = rng.random()
        if r < 0.3:
            return _WORDS[rng.integers(len(_WORDS))]
        if r < 0.5:
            return " ".join(
                ["word", "pvc", "x" * int(rng.integers(1, 30)), "a", ":",
                 "#", "the job will be in"][rng.integers(7)]
                for _ in range(rng.integers(1, 30)))
        return "".join(_ALPHABET[rng.integers(len(_ALPHABET))]
                       for _ in range(rng.integers(0, 40)))

    def value(depth):
        r = rng.random()
        if depth > 3 or r < 0.5:
            kind = rng.integers(7)
            if kind == 0:
                return int(rng.integers(-10**12, 10**12))
            if kind == 1:
                return float(rng.random() * 10.0 ** rng.integers(-20, 20))
            if kind == 2:
                return None
            if kind == 3:
                return bool(rng.random() < 0.5)
            if kind == 4:
                return float(rng.integers(0, 10**15)) * 10.0 ** 5
            return text()
        if r < 0.75:
            return {(text()[:40] or "k"): value(depth + 1)
                    for _ in range(rng.integers(0, 4))}
        return [value(depth + 1) for _ in range(rng.integers(0, 4))]

    if rng.random() < 0.5:
        return {(text()[:60] or "k"): value(0)
                for _ in range(rng.integers(0, 6))}
    return [value(0) for _ in range(rng.integers(0, 6))]


@pytest.mark.parametrize("seed", range(8))
def test_emitter_equals_pyyaml_on_random_documents(seed):
    rng = np.random.default_rng(seed)
    for _ in range(300):
        doc = _random_doc(rng)
        assert safe_dump(doc) == yaml.safe_dump(doc, sort_keys=False), doc


def test_emitter_refuses_other_types():
    for bad in ({"a": object()}, "scalar", {("t",): 1}):
        with pytest.raises(TypeError):
            safe_dump(bad)


# ------------------------------------------------- the CLI against a service

NODES = [("n1", {"cpu": "8", "memory": "16Gi", "pods": 110}),
         ("n2", {"cpu": "8", "memory": "16Gi", "pods": 110})]
_STAMP = re.compile(r"(first_seen|last_seen): [0-9.e+]+")


def _cli(pkg, argv):
    """The package's ``vtpuctl`` in this process: (rc, stdout)."""
    import importlib

    main = importlib.import_module(f"{pkg.__name__}.cli.main")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main.main(argv)
    return rc, out.getvalue()


def _cli_session(pkg):
    """The CLI verbs of ``test_admission_cli.py``'s service class and
    both example files, against the package's service pumped step by
    step; returns every output and the final API views."""
    reset_uid_counters()
    ps = PumpedService(pkg, nodes=NODES)
    srv = ["--server", ps.url]
    outs = []
    try:
        def cli(*argv):
            rc, text = _cli(pkg, srv + list(argv))
            assert rc == 0
            outs.append(_STAMP.sub(r"\1: <t>", text))
            return text

        cli("job", "run", "--name", "cj", "--replicas", "2",
            "--min-available", "2")
        for f in ("job.yaml", "tensorflow-dist.yaml"):
            cli("job", "run", "-f", str(REPO / "examples" / f))
        ps.pump(4)
        cli("job", "list")
        views = {name: cli("job", "view", "--name", name)
                 for name in ("cj", "test-job", "dist-mnist")}
        cli("job", "suspend", "--name", "cj")
        ps.pump(2)
        cli("job", "list", "-n", "default")
        cli("job", "resume", "--name", "cj")
        ps.pump(3)
        cli("queue", "create", "--name", "q9", "--weight", "4")
        cli("queue", "list")
        cli("queue", "operate", "--name", "q9", "-a", "close")
        ps.pump(1)
        cli("queue", "list")
        cli("queue", "operate", "--name", "q9", "-a", "open")
        ps.pump(1)
        cli("queue", "delete", "--name", "q9")
        cli("job", "delete", "--name", "cj")
        ps.pump(2)
        cli("job", "list")
        import importlib

        mod = importlib.import_module(f"{pkg.__name__}.cli.main")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            mod.vsub(srv + ["--name", "vs", "-r", "1"])
            mod.vqueues(srv)
        outs.append(out.getvalue())
        ps.pump(2)
        from urllib.request import urlopen

        with urlopen(ps.url + "/apis/jobs") as r:
            api_jobs = json.loads(r.read())
        job_views = {}
        for name in ("test-job", "dist-mnist", "vs"):
            with urlopen(f"{ps.url}/apis/jobs/default/{name}") as r:
                job_views[name] = json.loads(r.read())
    finally:
        ps.stop()
    return outs, views, api_jobs, job_views


def test_cli_against_port_service_prints_what_jax_prints():
    want, _, want_jobs, _ = _cli_session(volcano_tpu)
    got, views, got_jobs, job_views = _cli_session(volcano_tpu_torch)
    assert got == want
    assert got_jobs == want_jobs
    phases = {j["name"]: j["status"]["phase"] for j in got_jobs}
    assert phases == {"test-job": "Running", "dist-mnist": "Running",
                      "vs": "Running"}
    # Every view the session printed is yaml.safe_dump of what the API
    # returned, byte for byte (events included).
    for name, text in views.items():
        assert text == yaml.safe_dump(yaml.safe_load(text),
                                      sort_keys=False) + "\n"
    for name, view in job_views.items():
        assert safe_dump(view) == yaml.safe_dump(view, sort_keys=False)
        assert view["events"], name


def test_cli_rejections_match_jax(capsys):
    """A job the admission refuses: both CLIs exit 1 with the same
    message; a file past the YAML subset: the port names its line."""
    msgs = []
    for pkg in PKGS:
        reset_uid_counters()
        ps = PumpedService(pkg)
        try:
            with pytest.raises(SystemExit) as err:
                _cli(pkg, ["--server", ps.url, "job", "run", "--name",
                           "bad", "--queue", "nope"])
            assert err.value.code == 1
            msgs.append(capsys.readouterr().err)
        finally:
            ps.stop()
    assert msgs[0] == msgs[1] and "unable to find job queue" in msgs[0]


def test_cli_reports_yaml_outside_the_subset(tmp_path, capsys):
    bad = tmp_path / "bad.yaml"
    bad.write_text("name: x\ntasks: &anchor []\n")
    with pytest.raises(SystemExit):
        _cli(volcano_tpu_torch, ["--server", "http://127.0.0.1:9", "job",
                                 "run", "-f", str(bad)])
    err = capsys.readouterr().err
    assert "line 2" in err and str(bad) in err


def test_cli_child_runs_without_pyyaml():
    """``python -m volcano_tpu_torch.cli`` in a child where ``import
    yaml`` fails: it submits both example files and views a job."""
    reset_uid_counters()
    ps = PumpedService(volcano_tpu_torch, nodes=NODES)
    code = ("import sys, runpy; sys.modules['yaml'] = None; "
            "sys.argv = ['vtpuctl'] + sys.argv[1:]; "
            "runpy.run_module('volcano_tpu_torch.cli', run_name='__main__')")

    def child(*argv):
        out = subprocess.run([sys.executable, "-c", code,
                              "--server", ps.url, *argv],
                             capture_output=True, text=True, cwd=REPO,
                             timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        return out.stdout

    try:
        for f in ("job.yaml", "tensorflow-dist.yaml"):
            assert "successfully" in child("job", "run", "-f",
                                           f"examples/{f}")
        ps.pump(4)
        text = child("job", "view", "--name", "dist-mnist")
        from urllib.request import urlopen

        with urlopen(f"{ps.url}/apis/jobs/default/dist-mnist") as r:
            view = json.loads(r.read())
    finally:
        ps.stop()
    assert view["status"]["phase"] == "Running"
    assert text == yaml.safe_dump(view, sort_keys=False) + "\n"
