"""Resource arithmetic with Volcano's epsilon-tolerant comparison semantics.

Host-side scalar model. Reproduces the behavior of the reference's
``pkg/scheduler/api/resource_info.go``, in particular the
load-bearing epsilon tolerances of ``LessEqual`` (resource_info.go:286-320):
a request "fits" if it is below the target or within the minimum quantum
(10 milli-CPU / 10 MiB memory / 10 milli-units for scalar resources).

The device-array mirror of these semantics lives in
``volcano_tpu_torch.arrays.schema`` (fixed resource-slot vectors) and
``volcano_tpu_torch.ops.resreq`` (vectorized fit kernels); both must stay in exact
agreement with this module.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Iterable, Optional, Tuple

# Minimum quanta (the epsilon tolerances). Mirrors resource_info.go:70-72.
MIN_MILLI_CPU = 10.0
MIN_MILLI_SCALAR = 10.0
MIN_MEMORY = 10.0 * 1024 * 1024

# Well-known resource names.
CPU = "cpu"
MEMORY = "memory"
PODS = "pods"
GPU = "nvidia.com/gpu"  # resource_info.go:43-45


class Resource:
    """A multi-dimensional resource quantity.

    ``milli_cpu`` is in milli-cores, ``memory`` in bytes, and ``scalars`` maps
    extended resource names (e.g. ``nvidia.com/gpu``) to milli-units.
    ``max_task_num`` mirrors the pods capacity and is only consulted by
    predicates, never by arithmetic (resource_info.go:36-39).
    """

    __slots__ = ("milli_cpu", "memory", "scalars", "max_task_num")

    def __init__(
        self,
        milli_cpu: float = 0.0,
        memory: float = 0.0,
        scalars: Optional[Dict[str, float]] = None,
        max_task_num: int = 0,
    ):
        self.milli_cpu = float(milli_cpu)
        self.memory = float(memory)
        self.scalars: Optional[Dict[str, float]] = dict(scalars) if scalars else None
        self.max_task_num = max_task_num

    # ------------------------------------------------------------------ build

    @classmethod
    def empty(cls) -> "Resource":
        return cls()

    @classmethod
    def from_resource_list(cls, rl: Dict[str, object]) -> "Resource":
        """Build from a k8s-style resource list.

        Accepts quantities as numbers in *whole units* (cpu cores, memory
        bytes, scalar units) or strings using k8s quantity suffixes
        ("2", "500m", "1Gi", "512Mi").  cpu and extended scalars are stored
        in milli-units.  Mirrors NewResource (resource_info.go:75-93).
        """
        r = cls()
        for name, quant in rl.items():
            if name == CPU:
                r.milli_cpu += parse_milli(quant)
            elif name == MEMORY:
                r.memory += parse_bytes(quant)
            elif name == PODS:
                r.max_task_num += int(parse_count(quant))
            else:
                r.add_scalar(name, parse_milli(quant))
        return r

    def clone(self) -> "Resource":
        r = Resource.__new__(Resource)
        r.milli_cpu = self.milli_cpu
        r.memory = self.memory
        r.scalars = dict(self.scalars) if self.scalars else None
        r.max_task_num = self.max_task_num
        return r

    # ------------------------------------------------------------- predicates

    def is_empty(self) -> bool:
        """True when every dimension is below its minimum quantum."""
        if not (self.milli_cpu < MIN_MILLI_CPU and self.memory < MIN_MEMORY):
            return False
        if self.scalars:
            for quant in self.scalars.values():
                if quant >= MIN_MILLI_SCALAR:
                    return False
        return True

    def is_zero(self, name: str) -> bool:
        if name == CPU:
            return self.milli_cpu < MIN_MILLI_CPU
        if name == MEMORY:
            return self.memory < MIN_MEMORY
        if not self.scalars:
            return True
        if name not in self.scalars:
            raise KeyError(f"unknown resource {name}")
        return self.scalars[name] < MIN_MILLI_SCALAR

    # ------------------------------------------------------------- arithmetic

    def add(self, rr: "Resource") -> "Resource":
        self.milli_cpu += rr.milli_cpu
        self.memory += rr.memory
        if rr.scalars:
            if self.scalars is None:
                self.scalars = {}
            for name, quant in rr.scalars.items():
                self.scalars[name] = self.scalars.get(name, 0.0) + quant
        return self

    def sub(self, rr: "Resource") -> "Resource":
        """Subtract; asserts sufficiency first (resource_info.go:145-159)."""
        assert rr.less_equal(self), (
            f"resource is not sufficient to do operation: <{self}> sub <{rr}>"
        )
        self.milli_cpu -= rr.milli_cpu
        self.memory -= rr.memory
        if rr.scalars:
            if self.scalars is None:
                return self
            for name, quant in rr.scalars.items():
                self.scalars[name] = self.scalars.get(name, 0.0) - quant
        return self

    def set_max_resource(self, rr: "Resource") -> None:
        if rr is None:
            return
        self.milli_cpu = max(self.milli_cpu, rr.milli_cpu)
        self.memory = max(self.memory, rr.memory)
        if rr.scalars:
            if self.scalars is None:
                self.scalars = dict(rr.scalars)
                return
            for name, quant in rr.scalars.items():
                if quant > self.scalars.get(name, 0.0):
                    self.scalars[name] = quant

    def fit_delta(self, rr: "Resource") -> "Resource":
        """Subtract request plus one quantum for each requested dimension.

        A negative field afterwards means that dimension is insufficient
        (resource_info.go:193-213).
        """
        if rr.milli_cpu > 0:
            self.milli_cpu -= rr.milli_cpu + MIN_MILLI_CPU
        if rr.memory > 0:
            self.memory -= rr.memory + MIN_MEMORY
        if rr.scalars:
            if self.scalars is None:
                self.scalars = {}
            for name, quant in rr.scalars.items():
                if quant > 0:
                    self.scalars[name] = (
                        self.scalars.get(name, 0.0) - quant - MIN_MILLI_SCALAR
                    )
        return self

    def multi(self, ratio: float) -> "Resource":
        self.milli_cpu *= ratio
        self.memory *= ratio
        if self.scalars:
            for name in self.scalars:
                self.scalars[name] *= ratio
        return self

    # ------------------------------------------------------------ comparison

    def less(self, rr: "Resource") -> bool:
        """Strict elementwise less-than (resource_info.go:226-261)."""
        if not self.milli_cpu < rr.milli_cpu:
            return False
        if not self.memory < rr.memory:
            return False
        if self.scalars is None:
            if rr.scalars is not None:
                for quant in rr.scalars.values():
                    if quant <= MIN_MILLI_SCALAR:
                        return False
            return True
        if rr.scalars is None:
            return False
        for name, quant in self.scalars.items():
            if not quant < rr.scalars.get(name, 0.0):
                return False
        return True

    def less_equal_strict(self, rr: "Resource") -> bool:
        """Elementwise <= with no epsilon (resource_info.go:264-283)."""
        if not self.milli_cpu <= rr.milli_cpu:
            return False
        if not self.memory <= rr.memory:
            return False
        if self.scalars:
            rs = rr.scalars or {}
            for name, quant in self.scalars.items():
                if not quant <= rs.get(name, 0.0):
                    return False
        return True

    def less_equal(self, rr: "Resource") -> bool:
        """Epsilon-tolerant fit comparison (resource_info.go:286-320).

        Each dimension passes when ``l < r`` or ``|l - r| < quantum``; scalar
        dimensions requesting no more than one quantum always pass.
        """

        def le(l: float, r: float, diff: float) -> bool:
            return l < r or abs(l - r) < diff

        if not le(self.milli_cpu, rr.milli_cpu, MIN_MILLI_CPU):
            return False
        if not le(self.memory, rr.memory, MIN_MEMORY):
            return False
        if self.scalars is None:
            return True
        for name, quant in self.scalars.items():
            if quant <= MIN_MILLI_SCALAR:
                continue
            if rr.scalars is None:
                return False
            if not le(quant, rr.scalars.get(name, 0.0), MIN_MILLI_SCALAR):
                return False
        return True

    def diff(self, rr: "Resource") -> Tuple["Resource", "Resource"]:
        """Return (increased, decreased) vs rr (resource_info.go:323-355)."""
        inc = Resource.empty()
        dec = Resource.empty()
        if self.milli_cpu > rr.milli_cpu:
            inc.milli_cpu += self.milli_cpu - rr.milli_cpu
        else:
            dec.milli_cpu += rr.milli_cpu - self.milli_cpu
        if self.memory > rr.memory:
            inc.memory += self.memory - rr.memory
        else:
            dec.memory += rr.memory - self.memory
        if self.scalars:
            rs = rr.scalars or {}
            for name, quant in self.scalars.items():
                rr_quant = rs.get(name, 0.0)
                if quant > rr_quant:
                    inc.add_scalar(name, quant - rr_quant)
                else:
                    dec.add_scalar(name, rr_quant - quant)
        return inc, dec

    # ---------------------------------------------------------------- access

    def get(self, name: str) -> float:
        if name == CPU:
            return self.milli_cpu
        if name == MEMORY:
            return self.memory
        if self.scalars is None:
            return 0.0
        return self.scalars.get(name, 0.0)

    def resource_names(self) -> Iterable[str]:
        names = [CPU, MEMORY]
        if self.scalars:
            names.extend(self.scalars.keys())
        return names

    def add_scalar(self, name: str, quantity: float) -> None:
        self.set_scalar(name, (self.scalars or {}).get(name, 0.0) + quantity)

    def set_scalar(self, name: str, quantity: float) -> None:
        if self.scalars is None:
            self.scalars = {}
        self.scalars[name] = quantity

    # ----------------------------------------------------------------- misc

    def __repr__(self) -> str:
        s = f"cpu {self.milli_cpu:.2f}, memory {self.memory:.2f}"
        if self.scalars:
            for name, quant in self.scalars.items():
                s += f", {name} {quant:.2f}"
        return s

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Resource):
            return NotImplemented
        return (
            self.milli_cpu == other.milli_cpu
            and self.memory == other.memory
            and (self.scalars or {}) == (other.scalars or {})
        )


def res_min(l: Resource, r: Resource) -> Resource:
    """Elementwise minimum (api/helpers/helpers.go:28-44)."""
    res = Resource(min(l.milli_cpu, r.milli_cpu), min(l.memory, r.memory))
    if l.scalars is None or r.scalars is None:
        return res
    res.scalars = {}
    for name, quant in l.scalars.items():
        res.scalars[name] = min(quant, r.scalars.get(name, 0.0))
    return res


def share(l: float, r: float) -> float:
    """Share ratio with 0/0 -> 0 and x/0 -> 1 (api/helpers/helpers.go:46-59)."""
    if r == 0:
        return 0.0 if l == 0 else 1.0
    return l / r


# --------------------------------------------------------------------- parse

_BINARY_SUFFIXES = {
    "Ki": 1024.0,
    "Mi": 1024.0**2,
    "Gi": 1024.0**3,
    "Ti": 1024.0**4,
    "Pi": 1024.0**5,
    "Ei": 1024.0**6,
}
_DECIMAL_SUFFIXES = {
    "k": 1e3,
    "M": 1e6,
    "G": 1e9,
    "T": 1e12,
    "P": 1e15,
    "E": 1e18,
}


def parse_quantity(q: object) -> float:
    """Parse a k8s quantity string (or pass through a number) to a float."""
    if isinstance(q, (int, float)):
        return float(q)
    return _parse_text(str(q))


# A cluster spells its quantities with a few distinct strings, parsed once
# per pod and node: the parses are kept (a pure function of the string).
@functools.lru_cache(maxsize=4096)
def _parse_text(text: str) -> float:
    s = text.strip()
    if s.endswith("m"):
        return float(s[:-1]) / 1000.0
    for suf, mult in _BINARY_SUFFIXES.items():
        if s.endswith(suf):
            return float(s[: -len(suf)]) * mult
    for suf, mult in _DECIMAL_SUFFIXES.items():
        if s.endswith(suf):
            return float(s[: -len(suf)]) * mult
    return float(s)


def parse_milli(q: object) -> float:
    """Quantity -> milli-units (k8s Quantity.MilliValue: rounded UP to
    an integral milli count).  Integrality is load-bearing beyond
    parity with the reference: the incremental cycle aggregates
    (fastpath_incr.py) rely on requests being exact in float64 so the
    subtract-old/add-new delta planes stay bit-for-bit with a full
    rebuild — a fractional milli value would accrue ulp drift."""
    if isinstance(q, (int, float)):
        # Numbers are whole units (e.g. cpu: 2 -> 2000 milli); a
        # fractional number (cpu: 0.0001) rounds up like the reference.
        return float(math.ceil(float(q) * 1000.0))
    return float(math.ceil(parse_quantity(q) * 1000.0))


def parse_bytes(q: object) -> float:
    """Quantity -> bytes (k8s Quantity.Value: rounded UP to an integral
    byte count; same integrality contract as parse_milli)."""
    if isinstance(q, (int, float)):
        return float(math.ceil(float(q)))
    return float(math.ceil(parse_quantity(q)))


def parse_count(q: object) -> float:
    return parse_quantity(q)
