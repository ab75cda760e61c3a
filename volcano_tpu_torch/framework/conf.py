"""Scheduler configuration schema and its parser.

Same YAML shape as the reference (``pkg/scheduler/conf/scheduler_conf.go``)
and as the JAX package's ``framework/conf.py``: an ``actions`` string,
plugin ``tiers`` with 11 per-plugin enable flags and free-form
``arguments``, and per-action ``configurations``.  Defaults mirror
``pkg/scheduler/plugins/defaults.go:20-55`` (every flag defaults to enabled
except ``enableBestNode``).

The port carries no YAML library, so ``parse_scheduler_conf`` reads the
subset of YAML a scheduler conf uses itself: block mappings and block
sequences by indentation, ``# comments``, plain and quoted scalars resolved
the way YAML 1.1's safe loader resolves them (null, bool, int, float,
string).  Anything else -- flow collections, anchors and aliases, block
scalars, tags, multiple documents, tabs, unknown top-level keys -- raises
``ValueError``: a conf the port would read differently is refused, never
guessed at.

``load_yaml`` reads the same subset widened to one-line flow collections of
scalars (``[]``, ``{}``, ``[a, b]``, ``{a: 1}``) -- what job files use --
for the CLI's ``job run -f``; it raises with the line number where the
subset ends, as the conf reader does.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class PluginOption:
    name: str
    enabled_job_order: Optional[bool] = None
    enabled_namespace_order: Optional[bool] = None
    enabled_job_ready: Optional[bool] = None
    enabled_job_pipelined: Optional[bool] = None
    enabled_task_order: Optional[bool] = None
    enabled_preemptable: Optional[bool] = None
    enabled_reclaimable: Optional[bool] = None
    enabled_queue_order: Optional[bool] = None
    enabled_predicate: Optional[bool] = None
    enabled_best_node: Optional[bool] = None
    enabled_node_order: Optional[bool] = None
    arguments: Dict[str, str] = field(default_factory=dict)

    def apply_defaults(self) -> None:
        """Nil flags default to enabled (defaults.go:20-55); best-node
        stays opt-in."""
        for f in (
            "enabled_job_order",
            "enabled_namespace_order",
            "enabled_job_ready",
            "enabled_job_pipelined",
            "enabled_task_order",
            "enabled_preemptable",
            "enabled_reclaimable",
            "enabled_queue_order",
            "enabled_predicate",
            "enabled_node_order",
        ):
            if getattr(self, f) is None:
                setattr(self, f, True)


@dataclass
class Tier:
    plugins: List[PluginOption] = field(default_factory=list)


@dataclass
class Configuration:
    name: str
    arguments: Dict[str, str] = field(default_factory=dict)


@dataclass
class SchedulerConfiguration:
    actions: str = ""
    tiers: List[Tier] = field(default_factory=list)
    configurations: List[Configuration] = field(default_factory=list)


_YAML_FLAGS = {
    "enableJobOrder": "enabled_job_order",
    "enableNamespaceOrder": "enabled_namespace_order",
    "enableJobReady": "enabled_job_ready",
    "enableJobPipelined": "enabled_job_pipelined",
    "enableTaskOrder": "enabled_task_order",
    "enablePreemptable": "enabled_preemptable",
    "enableReclaimable": "enabled_reclaimable",
    "enableQueueOrder": "enabled_queue_order",
    "enablePredicate": "enabled_predicate",
    "enableBestNode": "enabled_best_node",
    "enableNodeOrder": "enabled_node_order",
}

_TOP_KEYS = ("actions", "tiers", "configurations")

# ------------------------------------------------------- YAML subset

# YAML 1.1 implicit scalar types, as the safe loader resolves plain
# scalars.
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL_T = re.compile(r"^(?:yes|Yes|YES|true|True|TRUE|on|On|ON)$")
_BOOL_F = re.compile(r"^(?:no|No|NO|false|False|FALSE|off|Off|OFF)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?)$"
)
# Binary, octal, hex and sexagesimal numbers: YAML 1.1 reads them as
# numbers in ways a conf never needs; refused rather than misread.
_OTHER_NUM = re.compile(
    r"^[-+]?(?:0b[0-1_]+|0[0-7_]+|0x[0-9a-fA-F_]+"
    r"|[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?)$"
)
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str):
        self.no = no
        self.indent = indent
        self.text = text


def _fail(no: int, why: str):
    return ValueError(f"line {no}: {why}")


def _strip_comment(raw: str, no: int, flow: bool = False) -> str:
    """Drop a ``# comment`` that is outside quotes (YAML needs a space or
    line start before the ``#``)."""
    starts = ("", ":", "-", "[", "{", ",") if flow else ("", ":", "-")
    quote = None
    i = 0
    while i < len(raw):
        ch = raw[i]
        if quote:
            if ch == quote:
                if quote == "'" and raw[i + 1:i + 2] == "'":
                    i += 1  # '' is an escaped quote
                else:
                    quote = None
            elif ch == "\\" and quote == '"':
                i += 1
        elif ch in "'\"" and raw[:i].rstrip()[-1:] in starts:
            # A quote opens a scalar only where a scalar starts.
            quote = ch
        elif ch == "#" and (i == 0 or raw[i - 1] in " \t"):
            return raw[:i].rstrip()
        i += 1
    if quote:
        raise _fail(no, "unterminated quoted scalar")
    return raw.rstrip()


def _lines(text: str, flow: bool = False) -> List[_Line]:
    out = []
    for no, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip(" \t"))]:
            raise _fail(no, "tab indentation")
        body = _strip_comment(raw, no, flow)
        stripped = body.strip()
        if not stripped:
            continue
        if stripped in ("---", "..."):
            if out:
                raise _fail(no, "multiple documents")
            continue
        if stripped.startswith(("%", "&", "*", "!", "|", ">", "{", "[")):
            raise _fail(no, f"unsupported YAML construct {stripped[:1]!r}")
        out.append(_Line(no, len(body) - len(body.lstrip(" ")), stripped))
    return out


def _flow_items(body: str, no: int) -> List[str]:
    """Split a one-line flow collection's inside at its top-level commas
    (a trailing comma ends it); a nested collection raises."""
    items, cur, quote, i = [], [], None, 0
    while i < len(body):
        ch = body[i]
        if quote:
            if ch == quote:
                if quote == "'" and body[i + 1:i + 2] == "'":
                    cur.append(ch)
                    i += 1
                else:
                    quote = None
            elif ch == "\\" and quote == '"':
                cur.append(ch)
                i += 1
                ch = body[i:i + 1]
        elif ch in "'\"" and "".join(cur).rstrip()[-1:] in ("", ":"):
            quote = ch
        elif ch in "[]{}":
            raise _fail(no, "nested flow collection")
        elif ch == ",":
            items.append("".join(cur).strip())
            cur = []
            i += 1
            continue
        cur.append(ch)
        i += 1
    last = "".join(cur).strip()
    if last or not items:
        items.append(last)
    if items == [""]:
        return []
    if "" in items:
        raise _fail(no, "empty entry in a flow collection")
    return items


def _flow(tok: str, no: int):
    """A one-line flow sequence or mapping of scalars."""
    close = "]" if tok[0] == "[" else "}"
    if not tok.endswith(close):
        raise _fail(no, f"unterminated flow collection {tok!r}")
    items = _flow_items(tok[1:-1], no)
    if close == "]":
        return [_scalar(item, no) for item in items]
    out: Dict[str, object] = {}
    for item in items:
        kv = _split_key(item, no)
        if kv is None:
            raise _fail(no, f"flow mapping entry without 'key: ', {item!r}")
        key, rest = kv
        if key in out:
            raise _fail(no, f"duplicate key {key!r}")
        out[key] = _scalar(rest, no) if rest else None
    return out


def _scalar(tok: str, no: int, flow: bool = False):
    """A plain or quoted scalar, resolved like YAML 1.1's safe loader; with
    ``flow``, also a one-line flow collection of such scalars."""
    tok = tok.strip()
    if flow and tok[:1] in ("[", "{"):
        return _flow(tok, no)
    if tok[:1] in ("'", '"'):
        q = tok[0]
        if len(tok) < 2 or tok[-1] != q:
            raise _fail(no, "bad quoted scalar")
        inner = tok[1:-1]
        if q == "'":
            if re.search(r"(?<!')'(?!')", inner.replace("''", "")):
                raise _fail(no, "bad single-quoted scalar")
            return inner.replace("''", "'")
        if "\\" in inner:
            simple = {"\\\\": "\\", '\\"': '"', "\\n": "\n", "\\t": "\t"}
            out, i = [], 0
            while i < len(inner):
                pair = inner[i:i + 2]
                if pair in simple:
                    out.append(simple[pair])
                    i += 2
                elif inner[i] == "\\":
                    raise _fail(no, f"unsupported escape {pair!r}")
                else:
                    out.append(inner[i])
                    i += 1
            return "".join(out)
        if '"' in inner:
            raise _fail(no, "bad double-quoted scalar")
        return inner
    if tok[:1] in ("&", "*", "!", "|", ">", "{", "[", "@", "`"):
        raise _fail(no, f"unsupported YAML construct {tok[:1]!r}")
    if _NULL.match(tok):
        return None
    if _BOOL_T.match(tok):
        return True
    if _BOOL_F.match(tok):
        return False
    if _INT.match(tok):
        return int(tok.replace("_", ""))
    if _FLOAT.match(tok):
        return float(tok.replace("_", ""))
    if _OTHER_NUM.match(tok):
        raise _fail(no, f"unsupported number form {tok!r}")
    if _INF.match(tok):
        return float("-inf") if tok.startswith("-") else float("inf")
    if _NAN.match(tok):
        return float("nan")
    if ": " in tok or tok.endswith(":"):
        raise _fail(no, f"unexpected mapping in scalar {tok!r}")
    return tok


def _split_key(text: str, no: int) -> Optional[Tuple[str, str]]:
    """``key: rest`` -> (key, rest); None when ``text`` is no mapping
    entry."""
    if text[:1] in ("'", '"'):
        q = text[0]
        end = text.find(q, 1)
        if end < 0:
            raise _fail(no, "bad quoted key")
        key, after = text[1:end], text[end + 1:]
        if not after.startswith(":"):
            return None
        return key, after[1:].strip()
    m = re.match(r"^([^:#]+?):(?:\s+(.*))?$", text)
    if m is None:
        return None
    return m.group(1).strip(), (m.group(2) or "").strip()


def _parse_block(lines: List[_Line], i: int, indent: int, flow: bool):
    """Parse the block node whose lines start at ``i`` with exactly
    ``indent``; returns (value, next index)."""
    if lines[i].text.startswith("- ") or lines[i].text == "-":
        return _parse_seq(lines, i, indent, flow)
    return _parse_map(lines, i, indent, flow)


def _value_after(lines, i, parent_indent, rest, no, seq_ok: bool, flow):
    """The value of a key whose inline text is ``rest``: the scalar, or
    the nested block on the following lines."""
    if rest:
        return _scalar(rest, no, flow), i + 1
    j = i + 1
    if j < len(lines) and (
            lines[j].indent > parent_indent
            or (seq_ok and lines[j].indent == parent_indent
                and lines[j].text.startswith("-"))):
        return _parse_block(lines, j, lines[j].indent, flow)
    return None, j


def _parse_map(lines, i, indent, flow):
    out: Dict[str, object] = {}
    while i < len(lines) and lines[i].indent == indent:
        ln = lines[i]
        if ln.text.startswith("-"):
            break
        kv = _split_key(ln.text, ln.no)
        if kv is None:
            raise _fail(ln.no, f"expected 'key: value', got {ln.text!r}")
        key, rest = kv
        if key in out:
            raise _fail(ln.no, f"duplicate key {key!r}")
        out[key], i = _value_after(lines, i, indent, rest, ln.no, True,
                                   flow)
    if i < len(lines) and lines[i].indent > indent:
        raise _fail(lines[i].no, "bad indentation")
    return out, i


def _parse_seq(lines, i, indent, flow):
    out: list = []
    while (i < len(lines) and lines[i].indent == indent
           and (lines[i].text.startswith("- ") or lines[i].text == "-")):
        ln = lines[i]
        body = ln.text[1:].lstrip(" ")
        if not body:
            val, i = _value_after(lines, i, indent, "", ln.no, False,
                                  flow)
            out.append(val)
            continue
        # "- key: value" opens a mapping whose further keys sit at the
        # column of ``key``.
        col = indent + (len(ln.text) - len(body))
        if body.startswith("- "):
            raise _fail(ln.no, "nested inline sequence")
        kv = (None if flow and body[:1] in ("[", "{")
              else _split_key(body, ln.no))
        if kv is None:
            out.append(_scalar(body, ln.no, flow))
            i += 1
            continue
        lines = lines[:i] + [_Line(ln.no, col, body)] + lines[i + 1:]
        val, i = _parse_map(lines, i, col, flow)
        out.append(val)
    if i < len(lines) and lines[i].indent > indent:
        raise _fail(lines[i].no, "bad indentation")
    return out, i


def _load(text: str, flow: bool = False):
    lines = _lines(text, flow)
    if not lines:
        return {}
    if lines[0].indent != 0:
        raise _fail(lines[0].no, "the document must start at column 0")
    val, i = _parse_block(lines, 0, 0, flow)
    if i != len(lines):
        raise _fail(lines[i].no, "trailing content")
    return val


def load_yaml(text: str, what: str = "YAML"):
    """The subset of YAML a job file uses, read as ``yaml.safe_load``
    reads it: block mappings and sequences, comments, plain and quoted
    scalars, one-line flow collections of scalars.  Anything else raises
    ``ValueError`` naming ``what`` and the line."""
    try:
        return _load(text, flow=True)
    except ValueError as err:
        raise ValueError(f"{what} {err}") from None


def _map_of(v, what: str) -> dict:
    if v is None:
        return {}
    if not isinstance(v, dict):
        raise ValueError(f"scheduler conf: {what} must be a mapping")
    return v


def _list_of(v, what: str) -> list:
    if v is None:
        return []
    if not isinstance(v, list):
        raise ValueError(f"scheduler conf: {what} must be a list")
    return v


def parse_scheduler_conf(conf_str: str) -> SchedulerConfiguration:
    """Parse the scheduler conf and apply plugin defaults
    (pkg/scheduler/util.go loadSchedulerConf)."""
    try:
        doc = _load(conf_str)
    except ValueError as err:
        raise ValueError(f"scheduler conf {err}") from None
    raw = _map_of(doc, "the document")
    unknown = sorted(set(raw) - set(_TOP_KEYS))
    if unknown:
        raise ValueError(f"scheduler conf: unknown keys {unknown}")
    actions = raw.get("actions", "")
    conf = SchedulerConfiguration(actions=actions)
    for tier_raw in _list_of(raw.get("tiers"), "tiers"):
        tier = Tier()
        for p in _list_of(_map_of(tier_raw, "a tier").get("plugins"),
                          "plugins"):
            p = _map_of(p, "a plugin")
            if "name" not in p:
                raise ValueError("scheduler conf: a plugin has no name")
            opt = PluginOption(name=p["name"])
            for yaml_key, attr in _YAML_FLAGS.items():
                if yaml_key in p:
                    setattr(opt, attr, bool(p[yaml_key]))
            opt.arguments = {
                str(k): str(v)
                for k, v in _map_of(p.get("arguments"), "arguments").items()
            }
            opt.apply_defaults()
            tier.plugins.append(opt)
        conf.tiers.append(tier)
    for c in _list_of(raw.get("configurations"), "configurations"):
        c = _map_of(c, "a configuration")
        conf.configurations.append(
            Configuration(
                name=c.get("name", ""),
                arguments={
                    str(k): str(v)
                    for k, v in _map_of(c.get("arguments"),
                                        "arguments").items()
                },
            )
        )
    return conf


# In-binary default configuration (pkg/scheduler/util.go:31-42).
DEFAULT_SCHEDULER_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""

# Deployed default plus the rebalance lane: gang-aware defragmentation
# with disruption budgets.  Separate from DEPLOYED_SCHEDULER_CONF because
# rebalance evicts running pods -- an operator opt-in.
REBALANCE_SCHEDULER_CONF = """
actions: "enqueue, allocate, backfill, rebalance"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
"""

# Shipped deployment default (installer helm chart config
# volcano-scheduler.conf: adds conformance + binpack).
DEPLOYED_SCHEDULER_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
"""
