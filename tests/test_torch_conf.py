"""The port's scheduler-conf parser (no YAML library) against the JAX
package's ``parse_scheduler_conf`` (PyYAML): identical parsed confs for
every conf constant and example file, scalar typing as YAML 1.1 resolves
it, and ``ValueError`` on YAML the parser does not read."""

from dataclasses import asdict
from pathlib import Path

import pytest

import volcano_tpu.framework.conf as jconf

import volcano_tpu_torch.framework.conf as tconf

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", ["DEFAULT_SCHEDULER_CONF",
                                  "DEPLOYED_SCHEDULER_CONF",
                                  "REBALANCE_SCHEDULER_CONF"])
def test_constants_parse_identically(name):
    assert getattr(tconf, name) == getattr(jconf, name)
    want = asdict(jconf.parse_scheduler_conf(getattr(jconf, name)))
    assert asdict(tconf.parse_scheduler_conf(getattr(tconf, name))) == want


@pytest.mark.parametrize("path", ["examples/scheduler-conf.yaml",
                                  "examples/preempt-conf.yaml"])
def test_example_files_parse_identically(path):
    text = (ROOT / path).read_text()
    assert asdict(tconf.parse_scheduler_conf(text)) == \
        asdict(jconf.parse_scheduler_conf(text))


SCALARS = """
# comment line
actions: 'enqueue, allocate'   # trailing comment
tiers:
  - plugins:
      - name: binpack
        enableNodeOrder: false
        enableJobOrder: Yes
        enablePredicate: off
        arguments:
          binpack.weight: 10
          binpack.cpu: 1.5
          binpack.memory: -2
          binpack.resources: "nvidia.com/gpu, #x"
          flag: true
          none: ~
          quoted: 'it''s'
          plain: a b c
  - plugins:
    - name: drf
configurations:
- name: allocate
  arguments:
    solver: wave
    rounds: 2
- name: enqueue
"""


def test_scalars_resolve_like_yaml():
    want = asdict(jconf.parse_scheduler_conf(SCALARS))
    got = asdict(tconf.parse_scheduler_conf(SCALARS))
    assert got == want
    args = got["tiers"][0]["plugins"][0]["arguments"]
    assert args["binpack.cpu"] == "1.5" and args["none"] == "None"
    assert got["tiers"][0]["plugins"][0]["enabled_node_order"] is False


def test_empty_conf():
    assert asdict(tconf.parse_scheduler_conf("")) == \
        asdict(jconf.parse_scheduler_conf(""))


@pytest.mark.parametrize("text", [
    "actions: enqueue\nfoo: 1\n",  # unknown top-level key
    "actions: {a: 1}\n",  # flow mapping
    "tiers: [a, b]\n",  # flow sequence
    "actions: &x enqueue\n",  # anchor
    "actions: |\n  enqueue\n",  # block scalar
    "actions: enqueue\n\tx: 1\n",  # tab indentation
    "actions: 'enqueue\n",  # unterminated quote
    "tiers:\n- plugins:\n  - name: a\n    rounds: 0x10\n",  # hex number
    "actions: enqueue\n---\nactions: allocate\n",  # two documents
    "tiers:\n- plugins:\n  - enableJobOrder: true\n",  # plugin without name
])
def test_unsupported_yaml_raises(text):
    with pytest.raises(ValueError):
        tconf.parse_scheduler_conf(text)


def test_quote_inside_plain_scalar():
    text = "actions: enqueue\ntiers:\n- plugins:\n  - name: it's # note\n"
    assert asdict(tconf.parse_scheduler_conf(text)) == \
        asdict(jconf.parse_scheduler_conf(text))
