"""The wave solve's and the device-incremental lane's hand-written CUDA
kernels, their loader, and their plain PyTorch versions.

=====================  ===================================================
wrapper                replaces (JAX package)
=====================  ===================================================
``coarse_shortlist``   ``ops/wave.py:_coarse_shortlist`` (:547) with
                       ``_class_static`` (:285) and ``_topk_nodes`` (:498);
                       ``n_blocks`` gives its ``with_cand`` form (per-block
                       top-k + ``_merge_block_cands``, :449), ``stat`` its
                       ``static_ext`` form
``rank_candidates``    ``live_parts_sl`` + ``rank_shortlist`` (:1302,
                       :1376); on all N nodes the fallback's ``live_parts``
                       + ``rank_nodes`` (:1192, :1277)
``walk_accept``        one sub-round's capacity walk, choice and in-order
                       acceptance (:1660-2003)
``apply_commit``       the sub-round apply (:2013-2021, :2125-2131) and the
                       final gang discard (:2262-2274)
``static_planes``      ``ops/wave.py:_static_planes`` (:347) for the block
                       form (the row form computes them in its launch)
``warm_shortlist``     ``ops/wave.py:_warm_shortlist`` (:721)
``scatter_planes``     ``ops/devsnap.py:_scatter_rows`` (:82) on every
                       plane of a node-table delta at once (counted as
                       ``scatter_rows``, as is the one-plane
                       ``scatter_rows``)
``victim_scores``      ``ops/victim.py:victim_scores`` (:82)
``frag_scores``        ``ops/rebalance.py:frag_scores`` (:61)
``gang_block_fit``     ``ops/topology.py:gang_block_fit`` (:179)
``fabric_frag``        ``ops/topology.py:fabric_frag`` (:240)
``seq_solve``          ``ops/allocate.py:solve`` (:201), the exact
                       sequential allocate solve (one persistent block,
                       per-profile node keys rescored where steps changed
                       them)
=====================  ===================================================

The inter-pod affinity kernels (``scatter_cnt0``, ``scatter_profile_tables``,
``aff_live``, ``aff_filter``, ``aff_steer``) have their wrappers in ``ops/affkernels.py``
and share this module's loader, launch counts and capture.

Each wrapper takes its inputs as tensors.  On CPU tensors it runs the
kernel's plain version; on CUDA tensors it launches the kernel (on torch's
current stream) or raises -- there is no fallback.  ``plain=True`` forces
the plain version on the card; only ``chip_smoke.py`` asks for it, to hold
the two against each other.  ``LAUNCHES`` counts kernel launches, one per
wrapper call that launched its kernel (``count_launch``, under a lock: a
pipelined session launches from two threads).

The five solve kernels take ``future``, a ``Future`` of the releasing
capacity planes: the JAX solve's has_future branch, where a fit reads
FutureIdle = ((idle + releasing) - pipelined) - pip_extra and pod slots
count ntasks + pip_ntasks (``None``: no releasing capacity).

The sources live in ``volcano_tpu_torch/csrc`` and build at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false`` into one
shared library with a plain C interface, loaded with ``ctypes``.  The build
directory (``csrc/_build``) is listed in ``.gitignore``.

Every selection orders by (score descending, position ascending): the
tie-break of ``jax.lax.top_k``, which ``torch.topk`` does not promise.  The
plain versions get it from a stable descending sort.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from .allocate import NEG
from .resreq import less_equal
from .scoring import node_score

LAUNCHES = {
    "coarse_shortlist": 0,
    "rank_candidates": 0,
    "walk_accept": 0,
    "apply_commit": 0,
    "static_planes": 0,
    "warm_shortlist": 0,
    "scatter_rows": 0,
    "victim_scores": 0,
    "frag_scores": 0,
    "gang_block_fit": 0,
    "fabric_frag": 0,
    "scatter_cnt0": 0,
    "scatter_profile_tables": 0,
    "aff_live": 0,
    "aff_filter": 0,
    "aff_steer": 0,
    "seq_solve": 0,
}

# Where each kernel's source lives and which JAX code it replaces
# (reported by chip_smoke.py's kernel line).
KERNEL_SOURCES = {
    "coarse_shortlist": "volcano_tpu_torch/csrc/coarse_shortlist.cu",
    "rank_candidates": "volcano_tpu_torch/csrc/rank_candidates.cu",
    "walk_accept": "volcano_tpu_torch/csrc/walk_accept.cu",
    "apply_commit": "volcano_tpu_torch/csrc/apply_commit.cu",
    "static_planes": "volcano_tpu_torch/csrc/coarse_shortlist.cu",
    "warm_shortlist": "volcano_tpu_torch/csrc/warm_shortlist.cu",
    "scatter_rows": "volcano_tpu_torch/csrc/scatter_rows.cu",
    "victim_scores": "volcano_tpu_torch/csrc/victim_scores.cu",
    "frag_scores": "volcano_tpu_torch/csrc/frag_scores.cu",
    "gang_block_fit": "volcano_tpu_torch/csrc/topology.cu",
    "fabric_frag": "volcano_tpu_torch/csrc/topology.cu",
    "scatter_cnt0": "volcano_tpu_torch/csrc/aff_tables.cu",
    "scatter_profile_tables": "volcano_tpu_torch/csrc/aff_tables.cu",
    "aff_live": "volcano_tpu_torch/csrc/aff_live.cu",
    "aff_filter": "volcano_tpu_torch/csrc/aff_filter.cu",
    "aff_steer": "volcano_tpu_torch/csrc/aff_steer.cu",
    "seq_solve": "volcano_tpu_torch/csrc/seq_solve.cu",
}
REPLACES = {
    "coarse_shortlist": "volcano_tpu/ops/wave.py:547",
    "rank_candidates": "volcano_tpu/ops/wave.py:1376",
    "walk_accept": "volcano_tpu/ops/wave.py:1660",
    "apply_commit": "volcano_tpu/ops/wave.py:2013",
    "static_planes": "volcano_tpu/ops/wave.py:347",
    "warm_shortlist": "volcano_tpu/ops/wave.py:721",
    "scatter_rows": "volcano_tpu/ops/devsnap.py:82",
    "victim_scores": "volcano_tpu/ops/victim.py:82",
    "frag_scores": "volcano_tpu/ops/rebalance.py:61",
    "gang_block_fit": "volcano_tpu/ops/topology.py:179",
    "fabric_frag": "volcano_tpu/ops/topology.py:240",
    "scatter_cnt0": "volcano_tpu/ops/wave.py:2296",
    "scatter_profile_tables": "volcano_tpu/ops/wave.py:2301",
    "aff_live": "volcano_tpu/ops/wave.py:1229",
    "aff_filter": "volcano_tpu/ops/wave.py:1749",
    "aff_steer": "volcano_tpu/ops/wave.py:1594",
    "seq_solve": "volcano_tpu/ops/allocate.py:201",
}

MAX_R = 16  # csrc/common.cuh kMaxR
MAX_SMEM = 232_448  # shared memory one block may use on Hopper
COARSE_SMEM = 224 * 1024  # csrc/coarse_shortlist.cu kRowSmem
BLOCK_MERGE_SMEM = 200 * 1024  # csrc/warm_shortlist.cu kMergeSmem
RANK_SORT_MAX = 2048  # csrc/rank_candidates.cu kSortMax
RANK_TILE = 1024  # csrc/rank_candidates.cu kTile
RANK_MERGE_SMEM = 224 * 1024  # csrc/rank_candidates.cu kMergeSmem
WALK_SMEM = 48 * 1024  # csrc/walk_accept.cu kWalkSmem
ACCEPT_SMEM = 200 * 1024  # csrc/walk_accept.cu kAccSmem
ACCEPT_KEY_BYTES = 9  # csrc/walk_accept.cu kKeyBytes

# Optional input capture: when a dict, each wrapper stores clones of the
# inputs of its first kernel launch under its name (chip_smoke.py replays
# them against the plain version).
CAPTURE: Optional[dict] = None


# Counts a kernel keeps on the card itself, where the host cannot know
# without a read: ``aff_live``'s and ``aff_steer``'s computing calls (a
# gated call does no work).  One int32 counter per (name, device), made at
# its first use after a reset; the plain versions add to the same counters.
TALLIES: dict = {}


# Launches of another wrapper's kernel that also did this one's work:
# ``static_planes``' counts the row-form ``coarse_shortlist`` launches that
# computed the static planes themselves (``LAUNCHES["static_planes"]``
# counts the planes' own launches), ``fabric_frag``'s the
# ``gang_block_fit`` launches, each of which writes ``frag``.
FUSED = {"static_planes": 0, "fabric_frag": 0}


# Two threads launch in a pipelined session (the cycle thread and the solve
# worker, ``pipeline.py``): the counts, the capture and the tallies are
# written under this lock, and a thread inside ``own_counts`` also counts
# its launches in its own dict (the worker's per-solve counts).
_COUNT_LOCK = threading.Lock()
_OWN = threading.local()


def count_launch(name: str, fused: Optional[str] = None) -> None:
    """One launch of ``name``'s kernel (which also did ``fused``'s work)."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        if fused is not None:
            FUSED[fused] += 1
        own = getattr(_OWN, "counts", None)
        if own is not None:
            own[name] = own.get(name, 0) + 1
            if fused is not None:
                key = f"{fused}:fused"
                own[key] = own.get(key, 0) + 1


class own_counts:
    """Within the block, the calling thread's launches are also counted
    in ``counts`` (``name``, and ``name:fused`` for ``FUSED``)."""

    def __init__(self, counts: dict):
        self.counts = counts

    def __enter__(self):
        self.prev = getattr(_OWN, "counts", None)
        _OWN.counts = self.counts
        return self.counts

    def __exit__(self, *exc):
        _OWN.counts = self.prev
        return False


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        for k in FUSED:
            FUSED[k] = 0
        TALLIES.clear()


def tally(name: str, dev) -> torch.Tensor:
    """The [1] int32 counter ``name`` on device ``dev``."""
    key = (name, str(dev))
    with _COUNT_LOCK:
        t = TALLIES.get(key)
        if t is None:
            t = TALLIES[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return t


def read_tally(name: str) -> int:
    """Counter ``name`` summed over devices (a host read: for reports and
    tests, never inside a solve)."""
    return sum(int(t[0]) for (n, _d), t in TALLIES.items() if n == name)


def _capture(name: str, **inputs) -> None:
    with _COUNT_LOCK:
        _capture_locked(name, inputs)


def _capture_locked(name: str, inputs: dict) -> None:
    if CAPTURE is None or name in CAPTURE:
        return
    def clone(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            return type(v)(*[clone(t) for t in v])
        if isinstance(v, (tuple, list)):
            return type(v)(clone(t) for t in v)
        return v

    CAPTURE[name] = {k: clone(v) for k, v in inputs.items()}


# --------------------------------------------------------------- loader

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = _CSRC / "_build"
_SOURCES = ("coarse_shortlist.cu", "rank_candidates.cu", "walk_accept.cu",
            "apply_commit.cu", "warm_shortlist.cu", "scatter_rows.cu",
            "victim_scores.cu", "frag_scores.cu", "topology.cu",
            "aff_tables.cu", "aff_live.cu", "aff_steer.cu", "aff_filter.cu",
            "seq_solve.cu", "launch_floor.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-Xcompiler", "-fPIC")
BUILD_SECONDS: Optional[float] = None
_LIB = None
_LIB_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: cannot build the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> Path:
    """Compile every source (one nvcc per source, started together) and
    link the shared library; reuse it while the sources are unchanged."""
    global BUILD_SECONDS
    h = hashlib.blake2b(digest_size=8)
    for name in sorted(os.listdir(_CSRC)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            h.update((_CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    lib = _BUILD / f"libvtt_kernels_{h.hexdigest()}.so"
    if lib.exists():
        BUILD_SECONDS = 0.0
        return lib
    _BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    procs = []
    objs = []
    for src in _SOURCES:
        obj = _BUILD / (src[:-3] + f"_{h.hexdigest()}.o")
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(_CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )))
    failed = []
    for src, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{src}:\n{out.decode(errors='replace')}")
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs), "-lcudart"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    if res.returncode != 0:
        raise RuntimeError(
            "kernel link failed\n" + res.stdout.decode(errors="replace")
        )
    os.replace(tmp, lib)
    BUILD_SECONDS = time.perf_counter() - t0
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_int64
_SIGS = {
    "vtt_coarse_shortlist": [_P, _P, _I, _I, _P, _I, _P, _I, _P, _P, _I, _P,
                             _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                             _P, _I, _P, _P, _P, _F, _F, _F, _F, _F, _I, _I,
                             _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                             _P, _P],
    "vtt_static_planes": [_I, _P, _I, _P, _I, _P, _P, _I, _P, _I, _P, _P,
                          _P, _P, _I, _F, _I, _P, _P, _P],
    "vtt_block_shortlist": [_I, _P, _P, _I, _I, _P, _P, _I, _P, _P, _P, _P,
                            _P, _P, _P, _P, _P, _P, _F, _F, _F, _F, _P, _I,
                            _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                            _P, _P, _P, _I, _P],
    "vtt_block_shortlist_smem": [_I, _I],
    "vtt_scatter_rows": [_P, _P, _P, _I, _L, _P],
    "vtt_scatter_planes": [_P, _I, _I, _P, _P],
    "vtt_rank_candidates": [_P, _I, _P, _I, _P, _P, _P, _I, _P, _P, _P, _I,
                            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F,
                            _F, _F, _F, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                            _P, _P, _P, _P, _P, _I, _P, _P, _P],
    "vtt_walk_accept": [_P, _P, _I, _I, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P,
                        _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                        _P, _I, _P, _P, _P, _P],
    "vtt_apply_commit": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _P, _P, _P,
                         _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, _I, _P, _P, _P, _I, _P, _P, _I, _I, _P, _P,
                         _P],
    "vtt_victim_scores": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                          _P, _I, _I, _I, _P, _L, _P, _P, _P, _P, _P],
    "vtt_frag_scores": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "vtt_gang_block_fit": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _P, _P, _P, _P, _P],
    "vtt_fabric_frag": [_P, _P, _P, _I, _I, _P, _P],
    "vtt_scatter_cnt0": [_P, _P, _P, _I, _I, _I, _P, _P],
    "vtt_scatter_profile_tables": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                                   _P, _P],
    "vtt_aff_live": [_P, _I, _P, _I, _I, _P, _I, _I, _P, _I, _P, _P, _P, _I,
                     _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "vtt_aff_filter": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _P, _P,
                       _P, _P, _P, _P, _P, _P, _P, _P],
    "vtt_aff_steer": [_P, _P, _I, _I, _P, _I, _P, _P, _P, _I, _I, _P, _P,
                      _P, _P, _P, _P, _P],
    "vtt_seq_solve": ([_I] * 13 + [_P] * 29 + [_F] * 5 + [_P] * 29
                      + [_I] * 2 + [_P] * 9),
    "vtt_empty_launch": [_I, _P],
}


def load():
    """Build (if needed) and load the kernel library; raises on failure."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _on_card(plain: bool, *tensors) -> bool:
    """True -> launch the kernel.  CPU tensors take the plain version; on
    the card only an explicit ``plain=True`` does."""
    cuda = [t.is_cuda for t in tensors if isinstance(t, torch.Tensor)]
    if any(cuda) and not all(cuda):
        raise ValueError("kernel inputs straddle the host and the card")
    return bool(cuda) and cuda[0] and not plain


def _req(t: torch.Tensor, dtype, name: str) -> torch.Tensor:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t


def _weights(weights):
    return (float(weights.binpack_weight), float(weights.least_req_weight),
            float(weights.most_req_weight), float(weights.balanced_weight))


class Future(NamedTuple):
    """Releasing-capacity planes of a solve (the JAX has_future branch):
    ``rel`` releasing and ``pip`` pipelined capacity at solve start, ``pxe``
    the in-solve pipelined charge (pip_extra), all [N, R] f32, and
    ``pip_ntasks`` [N] int32.  The shortlist passes read solve-start state
    and take ``pxe`` / ``pip_ntasks`` as None."""

    rel: torch.Tensor
    pip: torch.Tensor
    pxe: Optional[torch.Tensor] = None
    pip_ntasks: Optional[torch.Tensor] = None


def future_idle(idle, future: Optional[Future]):
    """FutureIdle, ((idle + releasing) - pipelined) - pip_extra, left to
    right (wave.py:609, :1207, :1661); the plain idle without ``future``."""
    if future is None:
        return idle
    fi = (idle + future.rel) - future.pip
    return fi if future.pxe is None else fi - future.pxe


def _total_ntasks(ntasks, future: Optional[Future]):
    if future is None or future.pip_ntasks is None:
        return ntasks
    return ntasks + future.pip_ntasks


def _future_args(future: Optional[Future], idle, ntasks, name: str):
    """The four pointers of ``future`` after the shape and type checks
    (null pointers without it)."""
    if future is None:
        return (None, None, None, None)
    f32 = torch.float32
    planes = [_req(future.rel, f32, f"{name} releasing"),
              _req(future.pip, f32, f"{name} pipelined")]
    if future.pxe is not None:
        planes.append(_req(future.pxe, f32, f"{name} pip_extra"))
    if any(t.shape != idle.shape for t in planes):
        raise ValueError(f"{name}: future planes are not [N, R]")
    pnt = future.pip_ntasks
    if pnt is not None:
        _req(pnt, torch.int32, f"{name} pip_ntasks")
        if pnt.shape != ntasks.shape:
            raise ValueError(f"{name}: pip_ntasks is not [N]")
    return (_ptr(future.rel), _ptr(future.pip), _ptr(future.pxe),
            _ptr(pnt))


class Ports(NamedTuple):
    """Host-port bit planes of a solve (uint32 words as int32): ``prof``
    the [U, PW] ports each profile row asks for, ``node`` the [N, PW]
    ports in use per node, ``pip`` those charged by pipelined tasks (or
    None).  A row asking for no port never clashes."""

    prof: torch.Tensor
    node: torch.Tensor
    pip: Optional[torch.Tensor] = None


class Extra(NamedTuple):
    """A custom plugin's per-profile [U, N] planes of a solve (the JAX
    ``extra_prof`` / ``score_prof``): ``ok`` bool verdicts ANDed into
    feasibility, ``score`` f32 added to the static score; either may be
    None."""

    ok: Optional[torch.Tensor] = None
    score: Optional[torch.Tensor] = None


def _extra_args(extra: Optional["Extra"], U: int, N: int, name: str):
    """(ok, score) pointers after the checks (nulls without)."""
    if extra is None:
        return (None, None)
    for t, dtype, what in ((extra.ok, torch.bool, "ok"),
                           (extra.score, torch.float32, "score")):
        if t is not None and _req(t, dtype, f"{name} extra {what}").shape \
                != (U, N):
            raise ValueError(f"{name}: extra {what} plane is not [{U}, {N}]")
    return (_ptr(extra.ok), _ptr(extra.score))


def _ports_ok_plain(pp, used):
    """``pp`` [M, PW] asked ports, ``used`` [M, L, PW] used ports at each
    candidate -> [M, L] no clash (wave.py:650-653, :1222-1227)."""
    has = (pp != 0).any(dim=-1)
    clash = ((pp[:, None, :] & used) != 0).any(dim=-1)
    return ~has[:, None] | ~clash


def _used_ports(ports: "Ports"):
    return ports.node if ports.pip is None else ports.node | ports.pip


def _ports_args(ports: Optional["Ports"], U: int, N: int, name: str):
    """(prof, PW, node, pip) pointers after the checks (nulls without
    ports)."""
    if ports is None:
        return (None, 0, None, None)
    i32 = torch.int32
    pp = _req(ports.prof, i32, f"{name} profile ports")
    nb = _req(ports.node, i32, f"{name} node ports")
    pw = pp.shape[1]
    if pp.shape != (U, pw) or nb.shape != (N, pw) or (
            ports.pip is not None
            and _req(ports.pip, i32, f"{name} pipelined ports").shape
            != (N, pw)):
        raise ValueError(f"{name}: inconsistent port plane shapes")
    return (_ptr(pp), pw, _ptr(nb), _ptr(ports.pip))


def _aff_planes(aff, M: int, L: int, name: str):
    """(ok, soft) pointers of the [M, L] affinity planes (nulls without)."""
    if aff is None:
        return (None, None)
    ok = _req(aff[0], torch.bool, f"{name} aff_ok")
    soft = _req(aff[1], torch.float32, f"{name} aff_soft")
    if ok.shape != (M, L) or soft.shape != (M, L):
        raise ValueError(f"{name}: affinity planes are not [{M}, {L}]")
    return (_ptr(ok), _ptr(soft))


# ------------------------------------------------- selection (plain)

def _select_desc(masked: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the top-k per row by (value desc, position asc)."""
    _vals, order = torch.sort(masked, dim=1, descending=True, stable=True)
    return order[:, :k]


# ---------------------------------------------------- coarse_shortlist

def class_static_plain(sel_bits, aff_bits, aff_terms, tol_bits, pref_bits,
                       pref_w, cls_label, cls_taint, cls_ready, naff: float,
                       has_taints: bool):
    """[U, C] static ok/score planes (wave.py:285 ``_class_static``):
    selector / required-affinity / taint subset tests on the packed words,
    preferred-affinity score summed left to right."""
    def subset(rows, table):
        # rows [..., W] against table [C, W] -> [..., C]
        miss = rows.unsqueeze(-2) & ~table
        return (miss == 0).all(dim=-1)

    U, A = aff_bits.shape[0], aff_bits.shape[1]
    AP = pref_bits.shape[1]
    ok = cls_ready[None, :] & subset(sel_bits, cls_label)
    term_ok = subset(aff_bits, cls_label)  # [U, A, C]
    term_real = (torch.arange(A, device=aff_terms.device)[None, :]
                 < aff_terms[:, None])
    ok = ok & ((term_ok & term_real[:, :, None]).any(dim=1)
               | (aff_terms == 0)[:, None])
    if has_taints:
        untol = (cls_taint[None, :, :] & ~tol_bits[:, None, :]) != 0
        ok = ok & ~untol.any(dim=-1)
    pref_match = subset(pref_bits, cls_label)  # [U, AP, C]
    acc = None
    for a in range(AP):
        term = pref_match[:, a].to(torch.float32) * pref_w[:, a:a + 1]
        acc = term if acc is None else acc + term
    return ok, naff * acc


def _masked_plain(req, init_req, stat_ok, stat_score, cid, idle, alloc,
                  ntasks, max_tasks, eps, scalar_slot, weights, fi0=None,
                  ports=None, aff=None, extra=None):
    """[U, M] solve-start scores of node rows whose planes are given
    (``cid`` their class ids), NEG where infeasible -- the coarse body
    (wave.py:640-664).  ``fi0`` is the solve-start FutureIdle the fit
    reads (``idle`` when None); ``ports`` a ``Ports`` whose ``node`` plane
    holds these rows; ``aff`` the rows' (ok, soft) affinity planes: the
    verdict joins the mask and the soft score joins after the static one,
    (node_score + static) + soft; ``extra`` the rows' custom-plugin planes
    (``Extra``), the verdict joining the mask and the score the static one
    (wave.py:642-645)."""
    cid = cid.long()
    feas = stat_ok[:, cid]
    static_score = stat_score[:, cid]
    if extra is not None and extra.ok is not None:
        feas = feas & extra.ok
    if extra is not None and extra.score is not None:
        static_score = static_score + extra.score
    fi0 = idle if fi0 is None else fi0
    fit = less_equal(init_req[:, None, :], fi0[None, :, :], eps, scalar_slot)
    pods_ok = (max_tasks <= 0) | (ntasks < max_tasks)
    feas = feas & fit & pods_ok[None, :]
    if ports is not None:
        U = ports.prof.shape[0]
        feas = feas & _ports_ok_plain(
            ports.prof, ports.node[None].expand(U, -1, -1))
    score = node_score(req[:, None, :], alloc[None], idle[None], weights)
    score = score + static_score
    if aff is not None:
        feas = feas & aff[0]
        score = score + aff[1]
    return torch.where(feas, score, torch.full_like(score, NEG))


def _coarse_plain(req, init_req, stat_ok, stat_score, cls_id, idle, alloc,
                  ntasks, max_tasks, eps, scalar_slot, weights, S, fi0=None,
                  ports=None, aff=None, extra=None):
    masked = _masked_plain(req, init_req, stat_ok, stat_score, cls_id, idle,
                           alloc, ntasks, max_tasks, eps, scalar_slot,
                           weights, fi0, ports, aff, extra)
    idx = _select_desc(masked, S)
    return torch.sort(idx, dim=1).values.to(torch.int32)


def _block_rank_plain(masked, block_ids, nlb: int, klb: int):
    """Per-block top-``klb`` of ``masked`` [U, nb * nlb] (the rows of
    blocks ``block_ids``, in that order) in rank order:
    ``(cand_s, cand_i [U, nb, klb])`` with global node ids."""
    U = masked.shape[0]
    nb = block_ids.shape[0]
    vals, order = torch.sort(masked.reshape(U, nb, nlb), dim=2,
                             descending=True, stable=True)
    gid = order[:, :, :klb] + (block_ids.long() * nlb)[None, :, None]
    return vals[:, :, :klb].contiguous(), gid.to(torch.int32)


def _merge_plain(cand_s, cand_i, S: int):
    """Top-``S`` over the [U, B * klb] candidate positions (ties to the
    lower position), ids sorted ascending (``_merge_block_cands`` + the
    ascending sort)."""
    U = cand_s.shape[0]
    pos = _select_desc(cand_s.reshape(U, -1), S)
    ids = torch.gather(cand_i.reshape(U, -1), 1, pos)
    return torch.sort(ids, dim=1).values.to(torch.int32)


def _prof_args(prof, cls, idle, alloc, ntasks, max_tasks, eps, scalar_slot,
               weights, stat=None):
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    a = dict(
        req=_req(prof.req, f32, "req"),
        init_req=_req(prof.init_req, f32, "init_req"),
        cls_id=_req(cls.class_id, i32, "class_id"),
        idle=_req(idle, f32, "idle"), alloc=_req(alloc, f32, "alloc"),
        ntasks=_req(ntasks, i32, "ntasks"),
        max_tasks=_req(max_tasks, i32, "max_tasks"),
        eps=_req(eps, f32, "eps"),
        scalar_slot=_req(scalar_slot, u8, "scalar_slot"),
        bres=_req(weights.binpack_res, f32, "binpack_res"),
    )
    if stat is None:
        a.update(
            sel_bits=_req(prof.sel_bits, i32, "sel_bits"),
            aff_bits=_req(prof.aff_bits, i32, "aff_bits"),
            aff_terms=_req(prof.aff_terms, i32, "aff_terms"),
            tol_bits=_req(prof.tol_bits, i32, "tol_bits"),
            pref_bits=_req(prof.pref_bits, i32, "pref_bits"),
            pref_w=_req(prof.pref_w, f32, "pref_w"),
            cls_label=_req(cls.label_bits, i32, "cls.label_bits"),
            cls_taint=_req(cls.taint_bits, i32, "cls.taint_bits"),
            cls_ready=_req(cls.ready, u8, "cls.ready"),
        )
    else:
        a.update(stat_ok=_req(stat[0], u8, "stat_ok"),
                 stat_score=_req(stat[1], f32, "stat_score"))
    N = idle.shape[0]
    R = prof.req.shape[1]
    if R > MAX_R:
        raise ValueError(f"{R} resource slots exceed the kernels' {MAX_R}")
    if a["cls_id"].shape[0] != N or alloc.shape != idle.shape:
        raise ValueError("coarse_shortlist: inconsistent node shapes")
    return a


def _block_geometry(N: int, B: int, S: int):
    if B < 1 or N % B:
        raise ValueError(f"{B} blocks do not divide {N} node rows")
    nlb = N // B
    klb = min(S, nlb)
    if not 1 <= S <= B * klb:
        raise ValueError(f"shortlist size {S} outside [1, {B * klb}]")
    smem = load().vtt_block_shortlist_smem(nlb, S)
    if smem > MAX_SMEM:
        raise ValueError(f"blocks of {nlb} rows / shortlists of {S} need "
                         f"{smem} bytes of shared memory")
    return nlb, klb


def _launch_block_shortlist(a, stat_ok, stat_score, weights, db, B, nlb,
                            klb, S, old, cand_s, cand_i, fut_ptrs, ports,
                            aff):
    U, R = a["req"].shape
    C = stat_ok.shape[1]
    N = a["idle"].shape[0]
    Ma = N if db is None else int(db.shape[0]) * nlb
    pp = _ports_args(ports, U, N, "block_shortlist")
    ap = _aff_planes(aff, U, Ma, "block_shortlist")
    dev = a["idle"].device
    # The merge's ordered scores: shared memory while they fit beside the
    # S winners' keys (csrc/warm_shortlist.cu merge_smem), else global.
    sel = 8 * max(64, 1 << (S - 1).bit_length())
    keys = (None if sel + 4 * B * klb <= BLOCK_MERGE_SMEM
            else torch.empty((U, B * klb), dtype=torch.int32, device=dev))
    out = torch.empty((U, S), dtype=torch.int32, device=dev)
    rc = load().vtt_block_shortlist(
        int(db is None), _ptr(a["req"]), _ptr(a["init_req"]), U, R,
        _ptr(stat_ok), _ptr(stat_score), C, _ptr(a["cls_id"]),
        _ptr(a["idle"]), fut_ptrs[0], fut_ptrs[1], _ptr(a["alloc"]),
        _ptr(a["ntasks"]),
        _ptr(a["max_tasks"]), _ptr(a["eps"]), _ptr(a["scalar_slot"]),
        _ptr(a["bres"]), *_weights(weights), _ptr(db),
        0 if db is None else int(db.shape[0]), B, nlb, klb, S,
        _ptr(old[0] if old else None), _ptr(old[1] if old else None),
        _ptr(cand_s), _ptr(cand_i), _ptr(keys), _ptr(out), *pp[:3], *ap, Ma,
        _stream(),
    )
    return rc, out


def coarse_shortlist(prof, cls, idle, alloc, ntasks, max_tasks, eps,
                     scalar_slot, weights, S: int, has_taints: bool,
                     stat=None, n_blocks: int = 0, future=None,
                     ports=None, aff=None, extra=None, plain: bool = False):
    """Phase 1: ``(shortlist [U, S] int32 ascending ids, stat_ok [U, C]
    bool, stat_score [U, C] f32)``, plus ``(cand_s [U, B, klb] f32,
    cand_i [U, B, klb] int32)`` when ``n_blocks`` (B) is given.

    ``prof`` is a ``SolveProfiles`` of tensors (bit planes as int32),
    ``cls`` a ``NodeClasses`` of tensors.  ``stat_ok``/``stat_score`` are
    the per-(profile, class) static planes phase 2 reuses: rows compute
    independently, so gathering a wave's rows equals evaluating them per
    wave (the JAX package's static_ext contract).  Without ``stat`` the
    launch computes them itself, each block its profile row's pairs
    (``FUSED["static_planes"]`` counts those launches); ``stat``, a pair
    of such planes, is taken as given instead (``static_ext``).
    ``n_blocks`` selects per node block (B ascending-id blocks of N / B
    rows, top ``klb = min(S, N / B)`` each, in rank order) and merges the
    winners (``with_cand``): the same shortlist, and the per-block
    candidates a later ``warm_shortlist`` patches.  It needs ``stat``
    (``static_planes`` builds the planes it reads: a block of that form
    cannot read pairs another block writes, and computing them in the
    launch measured slower than the planes' own launch, PERF.md).  With
    ``future`` (its ``rel`` and ``pip``) the fit reads fi0 = (idle +
    releasing) - pipelined (wave.py:608-609).  ``ports`` (a ``Ports``:
    the profile rows' asked ports and the nodes' solve-start ports) drops
    clashing nodes (wave.py:650-653); ``aff`` (``aff_live``'s [U, N]
    planes on the solve-start counts) masks required-affinity and
    anti-affinity violations and adds the soft score after the static one
    (wave.py:655-660).  ``extra`` (an ``Extra`` of [U, N] planes, the
    custom plugins') ANDs its verdicts into the mask and adds its scores
    to the static score, node_score + (static + extra) (wave.py:642-645);
    the block form does not take it (the JAX package drops the
    device-incremental lane for such solves)."""
    naff = float(weights.node_affinity_weight)
    if n_blocks and stat is None:
        raise ValueError("coarse_shortlist: n_blocks needs the static "
                         "planes (stat)")
    if n_blocks and extra is not None:
        raise ValueError("coarse_shortlist: the block form takes no "
                         "custom-plugin planes")
    if not _on_card(plain, idle, prof.req, cls.class_id):
        if stat is None:
            ok, score = class_static_plain(
                prof.sel_bits, prof.aff_bits, prof.aff_terms,
                prof.tol_bits, prof.pref_bits, prof.pref_w, cls.label_bits,
                cls.taint_bits, cls.ready, naff, has_taints,
            )
        else:
            ok, score = stat
        fi0 = future_idle(idle, future)
        if not n_blocks:
            sl = _coarse_plain(prof.req, prof.init_req, ok, score,
                               cls.class_id, idle, alloc, ntasks, max_tasks,
                               eps, scalar_slot, weights, S, fi0, ports, aff,
                               extra)
            return sl, ok, score
        N = idle.shape[0]
        nlb = N // n_blocks
        klb = min(S, nlb)
        masked = _masked_plain(prof.req, prof.init_req, ok, score,
                               cls.class_id, idle, alloc, ntasks, max_tasks,
                               eps, scalar_slot, weights, fi0, ports, aff)
        cand_s, cand_i = _block_rank_plain(
            masked, torch.arange(n_blocks, device=idle.device), nlb, klb)
        return (_merge_plain(cand_s, cand_i, S), ok, score, cand_s, cand_i)
    U, R = prof.req.shape
    N = idle.shape[0]
    C = cls.ready.shape[0] if stat is None else stat[0].shape[1]
    if not 1 <= S <= N:
        raise ValueError(f"shortlist size {S} outside [1, {N}]")
    a = _prof_args(prof, cls, idle, alloc, ntasks, max_tasks, eps,
                   scalar_slot, weights, stat)
    if stat is None and (
            a["cls_taint"].shape[1] != a["tol_bits"].shape[1]
            or a["cls_label"].shape[1] != a["sel_bits"].shape[1]):
        raise ValueError("coarse_shortlist: inconsistent bit-plane widths")
    if stat is not None and (a["stat_ok"].shape != (U, C)
                             or a["stat_score"].shape != (U, C)):
        raise ValueError("coarse_shortlist: static planes are not [U, C]")
    fut = _future_args(future, idle, ntasks, "coarse_shortlist")
    ep = _extra_args(extra, U, N, "coarse_shortlist")
    _capture("coarse_shortlist" + ("" if aff is None else ":aff")
             + ("" if extra is None else ":extra"),
             weights=weights, S=S, has_taints=has_taints,
             n_blocks=n_blocks, C=C, future=future, ports=ports, aff=aff,
             extra=extra, **a)
    dev = idle.device
    if n_blocks:
        nlb, klb = _block_geometry(N, n_blocks, S)
        cand_s = torch.empty((U, n_blocks, klb), dtype=torch.float32,
                             device=dev)
        cand_i = torch.empty((U, n_blocks, klb), dtype=torch.int32,
                             device=dev)
        rc, out = _launch_block_shortlist(
            a, a["stat_ok"], a["stat_score"], weights, None, n_blocks, nlb,
            klb, S, None, cand_s, cand_i, fut, ports, aff)
        _check(rc, "coarse_shortlist")
        count_launch("coarse_shortlist")
        return out, a["stat_ok"], a["stat_score"], cand_s, cand_i
    if stat is None:
        stat_ok = torch.empty((U, C), dtype=torch.bool, device=dev)
        stat_score = torch.empty((U, C), dtype=torch.float32, device=dev)
        static = (_ptr(a["sel_bits"]), a["sel_bits"].shape[-1],
                  _ptr(a["aff_bits"]), a["aff_bits"].shape[1],
                  _ptr(a["aff_terms"]), _ptr(a["tol_bits"]),
                  a["tol_bits"].shape[-1], _ptr(a["pref_bits"]),
                  a["pref_bits"].shape[1], _ptr(a["pref_w"]))
        tables = (_ptr(a["cls_label"]), _ptr(a["cls_taint"]),
                  _ptr(a["cls_ready"]))
    else:
        stat_ok, stat_score = a["stat_ok"], a["stat_score"]
        static = (None, 0, None, 0, None, None, 0, None, 0, None)
        tables = (None, None, None)
    # A row's ordered scores: shared memory up to COARSE_SMEM, else a
    # global scratch row.
    keys = (None if 4 * N <= COARSE_SMEM
            else torch.empty((U, N), dtype=torch.int32, device=dev))
    out = torch.empty((U, S), dtype=torch.int32, device=dev)
    pp = _ports_args(ports, U, N, "coarse_shortlist")
    ap = _aff_planes(aff, U, N, "coarse_shortlist")
    rc = load().vtt_coarse_shortlist(
        _ptr(a["req"]), _ptr(a["init_req"]), U, R, *static,
        _ptr(a["cls_id"]), *tables, C, _ptr(a["idle"]), fut[0], fut[1],
        _ptr(a["alloc"]), _ptr(a["ntasks"]), _ptr(a["max_tasks"]), N,
        _ptr(a["eps"]), _ptr(a["scalar_slot"]), _ptr(a["bres"]),
        *_weights(weights), naff, int(bool(has_taints)), S,
        int(stat is not None), _ptr(stat_ok), _ptr(stat_score), _ptr(keys),
        _ptr(out), *pp[:3], *ap, *ep, _stream(),
    )
    _check(rc, "coarse_shortlist")
    count_launch("coarse_shortlist",
                 fused="static_planes" if stat is None else None)
    return out, stat_ok, stat_score


# ------------------------------------------------------- static_planes

def static_planes(prof, cls, naff: float, has_taints: bool,
                  plain: bool = False):
    """The [U, C] static planes ``(ok bool, score f32)`` of every profile
    row against every node class (wave.py:347 ``_static_planes``): the
    device-incremental lane's persistent planes, which its block-form
    shortlist launches read (the row form computes its own)."""
    if not _on_card(plain, prof.sel_bits, cls.ready):
        return class_static_plain(
            prof.sel_bits, prof.aff_bits, prof.aff_terms, prof.tol_bits,
            prof.pref_bits, prof.pref_w, cls.label_bits, cls.taint_bits,
            cls.ready, float(naff), has_taints)
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    a = dict(
        sel_bits=_req(prof.sel_bits, i32, "sel_bits"),
        aff_bits=_req(prof.aff_bits, i32, "aff_bits"),
        aff_terms=_req(prof.aff_terms, i32, "aff_terms"),
        tol_bits=_req(prof.tol_bits, i32, "tol_bits"),
        pref_bits=_req(prof.pref_bits, i32, "pref_bits"),
        pref_w=_req(prof.pref_w, f32, "pref_w"),
        cls_label=_req(cls.label_bits, i32, "cls.label_bits"),
        cls_taint=_req(cls.taint_bits, i32, "cls.taint_bits"),
        cls_ready=_req(cls.ready, u8, "cls.ready"),
    )
    U = a["sel_bits"].shape[0]
    C = a["cls_ready"].shape[0]
    if (a["cls_taint"].shape[1] != a["tol_bits"].shape[1]
            or a["cls_label"].shape[1] != a["sel_bits"].shape[1]
            or a["aff_bits"].shape[0] != U or a["pref_w"].shape[0] != U):
        raise ValueError("static_planes: inconsistent input shapes")
    _capture("static_planes", naff=float(naff), has_taints=has_taints, **a)
    dev = a["sel_bits"].device
    ok = torch.empty((U, C), dtype=u8, device=dev)
    score = torch.empty((U, C), dtype=f32, device=dev)
    rc = load().vtt_static_planes(
        U, _ptr(a["sel_bits"]), a["sel_bits"].shape[1], _ptr(a["aff_bits"]),
        a["aff_bits"].shape[1], _ptr(a["aff_terms"]), _ptr(a["tol_bits"]),
        a["tol_bits"].shape[1], _ptr(a["pref_bits"]),
        a["pref_bits"].shape[1], _ptr(a["pref_w"]), _ptr(a["cls_label"]),
        _ptr(a["cls_taint"]), _ptr(a["cls_ready"]), C, float(naff),
        int(bool(has_taints)), _ptr(ok), _ptr(score), _stream(),
    )
    _check(rc, "static_planes")
    count_launch("static_planes")
    return ok, score


# ------------------------------------------------------ warm_shortlist

def _warm_plain(req, init_req, stat_ok, stat_score, cls_id, idle, alloc,
                ntasks, max_tasks, eps, scalar_slot, weights, db, cand_s,
                cand_i, S, future=None, ports=None, aff=None):
    B, klb = cand_s.shape[1], cand_s.shape[2]
    nlb = idle.shape[0] // B
    dbl = db.long()
    rows = (dbl[:, None] * nlb
            + torch.arange(nlb, device=idle.device)[None, :]).reshape(-1)
    masked = _masked_plain(req, init_req, stat_ok, stat_score, cls_id[rows],
                           idle[rows], alloc[rows], ntasks[rows],
                           max_tasks[rows], eps, scalar_slot, weights,
                           future_idle(idle, future)[rows],
                           None if ports is None else ports._replace(
                               node=ports.node[rows]), aff)
    s_new, i_new = _block_rank_plain(masked, db, nlb, klb)
    cs = cand_s.clone()
    ci = cand_i.clone()
    cs[:, dbl] = s_new
    ci[:, dbl] = i_new
    return _merge_plain(cs, ci, S), cs, ci


def warm_shortlist(prof, cls_id, stat_ok, stat_score, idle, alloc, ntasks,
                   max_tasks, eps, scalar_slot, weights, db, cand_s, cand_i,
                   S: int, future=None, ports=None, aff=None,
                   plain: bool = False):
    """Warm-started shortlists (wave.py:721 ``_warm_shortlist``):
    re-rank only the node blocks ``db`` ([ndb] int32, unique block ids),
    keep every other block's candidates from ``cand_s``/``cand_i``
    ([U, B, klb]), merge the winners.  Returns ``(shortlist [U, S] int32
    ascending ids, cand_s, cand_i)``; the candidates are new tensors (the
    inputs are never written).  ``future`` and ``ports`` as in
    ``coarse_shortlist`` (wave.py:763-768, :790-793); ``aff`` the
    affinity planes of the dirty blocks' rows ([U, ndb * nlb], blocks in
    ``db`` order, wave.py:777-812)."""
    if not _on_card(plain, idle, prof.req, db, cand_s):
        return _warm_plain(prof.req, prof.init_req, stat_ok, stat_score,
                           cls_id, idle, alloc, ntasks, max_tasks, eps,
                           scalar_slot, weights, db, cand_s, cand_i, S,
                           future, ports, aff)
    from .nodeclass import NodeClasses

    U, B, klb = cand_s.shape
    N = idle.shape[0]
    a = _prof_args(prof, NodeClasses(cls_id, None, None, None), idle, alloc,
                   ntasks, max_tasks, eps, scalar_slot, weights,
                   (stat_ok, stat_score))
    db = _req(db, torch.int32, "db")
    cand_s = _req(cand_s, torch.float32, "cand_s")
    cand_i = _req(cand_i, torch.int32, "cand_i")
    nlb, klb_want = _block_geometry(N, B, S)
    if (klb != klb_want or cand_i.shape != cand_s.shape
            or a["req"].shape[0] != U or stat_ok.shape[0] != U
            or db.dim() != 1 or not 1 <= db.shape[0] <= B):
        raise ValueError("warm_shortlist: inconsistent input shapes")
    fut = _future_args(future, idle, ntasks, "warm_shortlist")
    _capture("warm_shortlist" + ("" if aff is None else ":aff"),
             weights=weights, S=S, db=db, cand_s=cand_s, cand_i=cand_i,
             future=future, ports=ports, aff=aff, **a)
    dev = idle.device
    new_s = torch.empty_like(cand_s)
    new_i = torch.empty_like(cand_i)
    rc, out = _launch_block_shortlist(
        a, a["stat_ok"], a["stat_score"], weights, db, B, nlb, klb, S,
        (cand_s, cand_i), new_s, new_i, fut, ports, aff)
    _check(rc, "warm_shortlist")
    count_launch("warm_shortlist")
    return out, new_s, new_i


# -------------------------------------------------------- scatter_rows

def scatter_rows(buf: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
                 plain: bool = False) -> None:
    """``buf[rows] = vals`` in place along the leading axis, one plane
    (devsnap.py:82 ``_scatter_rows``; the snapshot writes its planes
    together with ``scatter_planes``).  ``rows`` [k] int32 must be unique
    and lie in ``[0, buf.shape[0])``; the caller checks that where the
    rows come from."""
    if not _on_card(plain, buf, rows, vals):
        buf[rows.long()] = vals
        return
    _req(buf, buf.dtype, "buf")
    _req(rows, torch.int32, "rows")
    _req(vals, buf.dtype, "vals")
    k = rows.shape[0]
    if rows.dim() != 1 or vals.shape != (k, *buf.shape[1:]):
        raise ValueError("scatter_rows: vals must be [len(rows), *row]")
    if k == 0:
        return
    _capture("scatter_rows:one_plane", buf=buf, rows=rows, vals=vals)
    row_bytes = buf[0].numel() * buf.element_size()
    rc = load().vtt_scatter_rows(_ptr(buf), _ptr(rows), _ptr(vals), k,
                                 row_bytes, _stream())
    _check(rc, "scatter_rows")
    count_launch("scatter_rows")


SCATTER_MAX_PLANES = 8  # csrc/scatter_rows.cu kMaxPlanes
_ALIGN = 16  # each staged plane starts at a multiple of 16 bytes


def plane_layout(nbytes) -> tuple:
    """(offsets, total bytes) of planes of ``nbytes`` bytes staged one after
    another in one buffer, each at the next multiple of 16 bytes."""
    offs = []
    end = 0
    for n in nbytes:
        end = -(-end // _ALIGN) * _ALIGN
        offs.append(end)
        end += int(n)
    return tuple(offs), end


def stage_planes(arrays, device) -> torch.Tensor:
    """One uint8 buffer on ``device`` holding the numpy ``arrays`` at
    ``plane_layout``'s offsets.  For the card the host packs it into pinned
    memory (PyTorch's caching host allocator, which keeps a block until the
    copies that read it are done) and copies it with one asynchronous copy;
    on the CPU the packed buffer is the staged one."""
    import numpy as np

    device = torch.device(device)
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offs, total = plane_layout([a.nbytes for a in arrays])
    host = torch.empty(max(total, _ALIGN), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    h = host.numpy()
    for off, a in zip(offs, arrays):
        h[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
    if device.type == "cpu":
        return host
    return host.to(device, non_blocking=True)


def staged_views(staged: torch.Tensor, specs) -> list:
    """The planes of ``staged`` (``stage_planes``) as views, one per
    ``(dtype, shape)`` of ``specs``, in order."""
    sizes = [torch.Size(shape).numel() * dt.itemsize for dt, shape in specs]
    offs, _ = plane_layout(sizes)
    return [staged[off:off + n].view(dt).view(shape)
            for off, n, (dt, shape) in zip(offs, sizes, specs)]


def delta_layout(k: int, row_bytes) -> tuple:
    """(offsets, total bytes) of a staged node-table delta of ``k`` rows:
    the int32 row ids at 0, then each plane's ``k * row_bytes[p]`` value
    bytes at the next multiple of 16."""
    offs, total = plane_layout([4 * k] + [k * int(rb) for rb in row_bytes])
    return offs[1:], total


def stage_delta(rows, vals, device) -> torch.Tensor:
    """One uint8 buffer on ``device`` holding a delta (``delta_layout``):
    ``rows`` [k] (unique node rows) and ``vals``, each plane's [k, *row]
    values as numpy arrays, staged by ``stage_planes``."""
    import numpy as np

    return stage_planes([np.asarray(rows, np.int32), *vals], device)


def _delta_views(bufs, staged, k):
    """The staged delta's row ids and each plane's [k, *row] values, as
    views of ``staged``."""
    rows, *vals = staged_views(staged, [(torch.int32, (k,))] + [
        (b.dtype, (k, *b.shape[1:])) for b in bufs])
    return rows, vals


def scatter_planes(bufs, staged: torch.Tensor, k: int,
                   plain: bool = False) -> None:
    """``buf[rows] = vals_p`` in place for every plane ``bufs[p]``, the
    rows and values read from ``staged`` (``stage_delta``): a node-table
    delta in one launch (devsnap.py:82 ``_scatter_rows``, once per plane in
    the JAX package).  The rows must be unique and lie in each plane's
    leading axis; the caller checks that where they come from.  The plain
    version writes plane by plane from views of ``staged``."""
    bufs = list(bufs)
    if not _on_card(plain, staged, *bufs):
        rows, vals = _delta_views(bufs, staged, k)
        for buf, v in zip(bufs, vals):
            buf[rows.long()] = v
        return
    _req(staged, torch.uint8, "staged")
    if not 1 <= len(bufs) <= SCATTER_MAX_PLANES:
        raise ValueError(f"scatter_planes: {len(bufs)} planes (1 to "
                         f"{SCATTER_MAX_PLANES})")
    row_bytes = [b[0].numel() * b.element_size() for b in bufs]
    offs, total = delta_layout(k, row_bytes)
    if staged.dim() != 1 or staged.numel() < total \
            or staged.data_ptr() % _ALIGN:
        raise ValueError("scatter_planes: staged buffer does not hold the "
                         "delta")
    for b in bufs:
        _req(b, b.dtype, "buf")
    if k == 0:
        return
    _capture("scatter_rows", bufs=tuple(bufs), staged=staged, k=k)
    desc = (ctypes.c_int64 * (3 * len(bufs)))(*[
        x for b, rb, off in zip(bufs, row_bytes, offs)
        for x in (b.data_ptr(), rb, off)])
    rc = load().vtt_scatter_planes(_ptr(staged), k, len(bufs),
                                   ctypes.c_void_p(ctypes.addressof(desc)),
                                   _stream())
    _check(rc, "scatter_planes")
    count_launch("scatter_rows")


# ----------------------------------------------------- rank_candidates

def _rank_plain(rows, cand, ok_w, score_w, cls_id, p_req, p_init_req, idle,
                alloc, ntasks, max_tasks, eps, scalar_slot, weights, K,
                future=None, bias=None, ports=None, aff=None, extra=None,
                pids=None):
    rows_l = rows.long()
    if cand is None:
        nodes = torch.arange(idle.shape[0], device=idle.device)[None, :]
        nodes = nodes.expand(rows.shape[0], -1)
    else:
        nodes = cand[rows_l].long()  # [M, L]
    cid = cls_id.long()[nodes]
    ok = torch.gather(ok_w[rows_l], 1, cid)
    sscore = torch.gather(score_w[rows_l], 1, cid)
    if extra is not None:
        prow = pids.long()[rows_l]
        if extra.ok is not None:
            ok = ok & torch.gather(extra.ok[prow], 1, nodes)
        if extra.score is not None:
            sscore = sscore + torch.gather(extra.score[prow], 1, nodes)
    if bias is not None:
        sscore = sscore + bias[nodes]
    idle_c = idle[nodes]  # [M, L, R]
    fit = less_equal(p_init_req[rows_l][:, None, :],
                     future_idle(idle, future)[nodes], eps, scalar_slot)
    mt = max_tasks[nodes]
    pods_ok = (mt <= 0) | (_total_ntasks(ntasks, future)[nodes] < mt)
    feas = ok & fit & pods_ok
    if ports is not None:
        feas = feas & _ports_ok_plain(ports.prof[rows_l],
                                      _used_ports(ports)[nodes])
    score = node_score(p_req[rows_l][:, None, :], alloc[nodes], idle_c,
                       weights) + sscore
    if aff is not None:
        feas = feas & aff[0]
        score = score + aff[1]
    masked = torch.where(feas, score, torch.full_like(score, NEG))
    pos = _select_desc(masked, K)
    ranked = torch.gather(nodes, 1, pos).to(torch.int32)
    return ranked, torch.gather(feas, 1, pos), feas.any(dim=1)


def rank_candidates(rows, cand, ok_w, score_w, cls_id, p_req, p_init_req,
                    idle, alloc, ntasks, max_tasks, eps, scalar_slot,
                    weights, K: int, future=None, bias=None, ports=None,
                    aff=None, extra=None, pids=None, plain: bool = False):
    """Live top-K of the wave profile rows ``rows`` ([M] int32 into the
    wave's [UM] rows).  ``cand`` is [UM, L] candidate node ids (a profile's
    ascending shortlist) or None for all N nodes.  ``ok_w``/``score_w`` are
    the wave rows of the static [U, C] planes.  With ``future`` the fit
    reads FutureIdle and pod slots count ntasks + pip_ntasks (wave.py:
    1205-1218, 1314-1322); the score keeps the live idle.  ``bias`` ([N]
    f32, the fabric topology's node-order bias) joins the static score
    before the live score does: node_score + (static + bias) (wave.py:1179,
    :1288); without it nothing is added.  ``ports`` (a ``Ports`` of the
    wave's [UM, PW] profile ports and the live node planes) drops nodes
    whose used ports (allocated | pipelined) clash (wave.py:1222-1227,
    :1329-1334); ``aff`` ([M, L] ok / soft planes of ``aff_live``, row b
    for ``rows[b]``) masks the affinity verdict and adds the soft score
    after the static one (wave.py:1385-1389).  ``extra`` (an ``Extra`` of
    the solve's [U, N] custom-plugin planes) is read at each wave row's
    profile ``pids`` ([UM] int32 into U): its verdict masks the candidate
    and its score joins the static score before the bias, node_score +
    ((static + extra) + bias) (wave.py:1127-1139, :1165-1179).  Returns
    ``(ranked [M, K] int32 node ids in rank order, feas_k [M, K] bool,
    p_any [M] bool)``."""
    if extra is not None and pids is None:
        raise ValueError("rank_candidates: extra planes need pids")
    if not _on_card(plain, idle, p_req, rows):
        return _rank_plain(rows, cand, ok_w, score_w, cls_id, p_req,
                           p_init_req, idle, alloc, ntasks, max_tasks, eps,
                           scalar_slot, weights, K, future, bias, ports, aff,
                           extra, pids)
    M = rows.shape[0]
    N, R = idle.shape
    L = N if cand is None else cand.shape[1]
    if M == 0:
        # No rows: nothing to launch (and nothing counted).
        dev = idle.device
        return (torch.empty((0, K), dtype=torch.int32, device=dev),
                torch.empty((0, K), dtype=torch.bool, device=dev),
                torch.empty((0,), dtype=torch.bool, device=dev))
    if not 1 <= K <= L:
        raise ValueError(f"ranking depth {K} outside [1, {L}]")
    if L > RANK_SORT_MAX and (8 << (K - 1).bit_length()) > RANK_MERGE_SMEM:
        raise ValueError(f"ranking depth {K}: the merge's sort exceeds "
                         f"shared memory")
    if R > MAX_R:
        raise ValueError(f"{R} resource slots exceed the kernels' {MAX_R}")
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    a = dict(
        rows=_req(rows, i32, "rows"),
        cand=None if cand is None else _req(cand, i32, "cand"),
        ok_w=_req(ok_w, u8, "ok_w"), score_w=_req(score_w, f32, "score_w"),
        cls_id=_req(cls_id, i32, "class_id"),
        p_req=_req(p_req, f32, "p_req"),
        p_init_req=_req(p_init_req, f32, "p_init_req"),
        idle=_req(idle, f32, "idle"), alloc=_req(alloc, f32, "alloc"),
        ntasks=_req(ntasks, i32, "ntasks"),
        max_tasks=_req(max_tasks, i32, "max_tasks"),
        eps=_req(eps, f32, "eps"),
        scalar_slot=_req(scalar_slot, u8, "scalar_slot"),
        bias=None if bias is None else _req(bias, f32, "bias"),
    )
    bres = _req(weights.binpack_res, f32, "binpack_res")
    UM = p_req.shape[0]
    if (ok_w.shape[0] != UM or score_w.shape != ok_w.shape
            or p_init_req.shape != p_req.shape
            or (cand is not None and cand.shape[0] != UM)
            or cls_id.shape[0] != N or alloc.shape != idle.shape
            or (bias is not None and bias.shape != (N,))):
        raise ValueError("rank_candidates: inconsistent input shapes")
    fut = _future_args(future, idle, ntasks, "rank_candidates")
    pp = _ports_args(ports, UM, N, "rank_candidates")
    ap = _aff_planes(aff, M, L, "rank_candidates")
    EN = 0
    ep = (None, None)
    if extra is not None:
        pids = _req(pids, i32, "pids")
        EN = N
        U_all = (extra.ok if extra.ok is not None else extra.score).shape[0]
        ep = _extra_args(extra, U_all, N, "rank_candidates")
        if pids.shape != (UM,):
            raise ValueError("rank_candidates: pids is not [UM]")
    # A biased launch, one with affinity planes, one with custom-plugin
    # planes and one over all N nodes are captured apart (chip_smoke.py
    # replays each).
    _capture("rank_candidates" + ("" if bias is None else ":bias")
             + ("" if aff is None else ":aff")
             + ("" if extra is None else ":extra")
             + ("" if cand is not None else ":fallback"),
             weights=weights, K=K, future=future, ports=ports, aff=aff,
             extra=extra, pids=pids if extra is not None else None, **a)
    dev = idle.device
    ranked = torch.empty((M, K), dtype=i32, device=dev)
    feas_k = torch.empty((M, K), dtype=u8, device=dev)
    p_any = torch.empty((M,), dtype=u8, device=dev)
    # A row past RANK_SORT_MAX runs as tiles of RANK_TILE and a merge: the
    # tiles' top keys, the feasibility by position and the tiles' flags.
    scratch = (None, None, None)
    if L > RANK_SORT_MAX:
        T = -(-L // RANK_TILE)
        scratch = (
            torch.empty((M, T, min(K, RANK_TILE)), dtype=torch.int64,
                        device=dev),
            torch.empty((M, L), dtype=u8, device=dev),
            torch.empty((M, T), dtype=u8, device=dev))
    rc = load().vtt_rank_candidates(
        _ptr(a["rows"]), M, _ptr(a["cand"]), L, _ptr(a["ok_w"]),
        _ptr(a["score_w"]), _ptr(a["bias"]), a["ok_w"].shape[1],
        _ptr(a["cls_id"]),
        _ptr(a["p_req"]), _ptr(a["p_init_req"]), R, _ptr(a["idle"]), *fut,
        _ptr(a["alloc"]), _ptr(a["ntasks"]), _ptr(a["max_tasks"]),
        _ptr(a["eps"]), _ptr(a["scalar_slot"]), _ptr(bres),
        *_weights(weights), K, *[_ptr(x) for x in scratch], _ptr(ranked),
        _ptr(feas_k), _ptr(p_any), *pp, *ap,
        _ptr(pids if extra is not None else None), EN, *ep, _stream(),
    )
    _check(rc, "rank_candidates")
    count_launch("rank_candidates")
    return ranked, feas_k, p_any


# --------------------------------------------------------- walk_accept

def _exclusive_segment_sum(key, vals):
    """sum of vals[t'] over t' < t with key[t'] == key[t] (vals [W, X],
    exact in float64)."""
    W = key.shape[0]
    order = torch.sort(key, stable=True).indices
    sv = vals[order]
    cs = torch.cumsum(sv, dim=0) - sv  # exclusive prefix
    sk = key[order]
    pos = torch.arange(W, device=key.device)
    is_start = torch.ones(W, dtype=torch.bool, device=key.device)
    is_start[1:] = sk[1:] != sk[:-1]
    start = torch.cummax(torch.where(is_start, pos, torch.zeros_like(pos)),
                         dim=0).values
    seg = cs - cs[start]
    out = torch.empty_like(seg)
    out[order] = seg
    return out


def _walk_plain(ranked, feas_k, p_req, p_init_req, pid_l, cand_s, any_feas,
                grp, idle, ntasks, max_tasks, eps, scalar_slot, future=None,
                ports=None, self_anti=None, live_out=None):
    UM, K = ranked.shape
    N = idle.shape[0]
    W = pid_l.shape[0]
    big = torch.tensor(1.0e9, dtype=torch.float32, device=idle.device)
    rk = ranked.long()
    fi = future_idle(idle, future)
    nt = _total_ntasks(ntasks, future)
    walk = fi[rk]  # [UM, K, R]
    req = p_req[:, None, :]
    per = torch.where(req > 0, walk / torch.clamp(req, min=1e-9),
                      torch.full_like(walk, float("inf")))
    c_res = torch.clamp(per.min(dim=-1).values, min=0.0)
    c_res = torch.minimum(c_res, big)
    mt = max_tasks[rk]
    c_pods = torch.where(mt > 0, (mt - nt[rk]).to(torch.float32), big)
    c = torch.where(feas_k, torch.minimum(torch.floor(c_res), c_pods),
                    torch.zeros_like(c_res))
    if self_anti is not None:
        # A profile anti-affine to its own labels takes one copy per node
        # (wave.py:1690-1696).
        c = torch.where(self_anti[:, None], torch.clamp(c, max=1.0), c)
    cumcap = torch.cumsum(c, dim=1)
    # m: earlier remaining candidates of my contention group.
    pl = pid_l.long()
    onehot = torch.zeros((W, UM), dtype=torch.int64, device=idle.device)
    onehot[torch.arange(W, device=idle.device), pl] = cand_s.long()
    before = torch.cumsum(onehot, dim=0) - onehot  # exclusive, [W, UM]
    m = (before * grp[pl].long()).sum(dim=1).to(torch.float32)
    j = (cumcap[pl] <= m[:, None]).sum(dim=1)
    cs = cand_s & any_feas
    overflow = cs & (j >= K)
    j = torch.clamp(j, 0, K - 1)
    choice = torch.clamp(rk[pl, j], 0, N - 1)
    live = cs & ~overflow
    req_w = p_req[pl].double() * live[:, None]
    ones = live.to(torch.float64)[:, None]
    pre = _exclusive_segment_sum(choice, torch.cat([req_w, ones], dim=1))
    R = p_req.shape[1]
    cum_req = pre[:, :R].to(torch.float32)
    cum_cnt = pre[:, R].round().to(torch.int32)
    need = p_init_req[pl] + cum_req
    fits_idle = less_equal(need, idle[choice], eps, scalar_slot)
    mt_c = max_tasks[choice]
    clean = live & ((mt_c <= 0) | (nt[choice] + cum_cnt < mt_c))
    if ports is not None:
        # Pair clash with an earlier live task on the same node, and the
        # live clash against the used ports (wave.py:1735-1747).
        pw = ports.prof[pl]  # [W, PW]
        tril = torch.ones((W, W), dtype=torch.bool,
                          device=idle.device).tril(-1)
        same = (choice[:, None] == choice[None, :]) & tril & live[None, :]
        pair = ((pw[:, None, :] & pw[None, :, :]) != 0).any(dim=-1)
        port_conf = (same & pair).any(dim=1)
        port_live = ((pw & _used_ports(ports)[choice]) != 0).any(dim=1)
        clean = clean & ~port_conf & ~port_live
    if live_out is not None:
        live_out.copy_(live)
    pipe = None
    if future is not None:
        fits_fut = less_equal(need, fi[choice], eps, scalar_slot)
        pipe = clean & ~fits_idle & fits_fut
    return choice.to(torch.int32), clean & fits_idle, pipe


def walk_accept(ranked, feas_k, p_req, p_init_req, pid_l, cand_s, any_feas,
                grp, idle, ntasks, max_tasks, eps, scalar_slot, future=None,
                ports=None, self_anti=None, live_out=None,
                plain: bool = False):
    """One sub-round's walk and acceptance before the affinity filter:
    ``(choice [W] int32, acc_alloc [W] bool, acc_pipe [W] bool or
    None)``.  ``ports`` (a ``Ports`` of the wave's profile ports and the
    live node planes) rejects a task whose ports clash with an earlier
    live task's on the same node or with the node's used ports;
    ``self_anti`` ([UM] bool: the profile is anti-affine to its own
    labels) caps its walk at one copy per node; ``live_out`` ([W] bool)
    receives the walk's live flags (the affinity filter's giver mask).
    ``pid_l`` is each task's row in the wave's [UM] profile list, ``grp``
    the [UM, UM] contention groups.  With ``future`` the walk reads
    FutureIdle, pod slots count ntasks + pip_ntasks, and a task that fits
    the future idle but not the live idle is accepted as pipelined
    (wave.py:1997-2003); without it ``acc_pipe`` is None."""
    if not _on_card(plain, idle, ranked, pid_l):
        return _walk_plain(ranked, feas_k, p_req, p_init_req, pid_l, cand_s,
                           any_feas, grp, idle, ntasks, max_tasks, eps,
                           scalar_slot, future, ports, self_anti, live_out)
    UM, K = ranked.shape
    N, R = idle.shape
    W = pid_l.shape[0]
    if R > MAX_R:
        raise ValueError(f"{R} resource slots exceed the kernels' {MAX_R}")
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    a = dict(
        ranked=_req(ranked, i32, "ranked"), feas_k=_req(feas_k, u8, "feas_k"),
        p_req=_req(p_req, f32, "p_req"),
        p_init_req=_req(p_init_req, f32, "p_init_req"),
        pid_l=_req(pid_l, i32, "pid_l"), cand_s=_req(cand_s, u8, "cand_s"),
        any_feas=_req(any_feas, u8, "any_feas"), grp=_req(grp, u8, "grp"),
        idle=_req(idle, f32, "idle"), ntasks=_req(ntasks, i32, "ntasks"),
        max_tasks=_req(max_tasks, i32, "max_tasks"),
        eps=_req(eps, f32, "eps"),
        scalar_slot=_req(scalar_slot, u8, "scalar_slot"),
    )
    if (feas_k.shape != ranked.shape or p_req.shape != (UM, R)
            or p_init_req.shape != (UM, R) or grp.shape != (UM, UM)
            or cand_s.shape != (W,) or any_feas.shape != (W,)):
        raise ValueError("walk_accept: inconsistent input shapes")
    fut = _future_args(future, idle, ntasks, "walk_accept")
    pp = _ports_args(ports, UM, N, "walk_accept")
    if self_anti is not None and _req(self_anti, u8,
                                      "self_anti").shape != (UM,):
        raise ValueError("walk_accept: self_anti is not [UM]")
    _capture("walk_accept" + ("" if ports is None and self_anti is None
                              else ":aff"),
             future=future, ports=ports, self_anti=self_anti, **a)
    dev = idle.device
    # Scratch the kernels keep in shared memory up to csrc/walk_accept.cu's
    # limits: the [UM, K] running capacities (48 KB a row) and the sort's
    # keys and flags (9 bytes per key of the power of two >= W, 200 KB).
    cumcap = (torch.empty((UM, K), dtype=f32, device=dev)
              if K * 4 > WALK_SMEM else None)
    sort_bytes = (1 << max(W - 1, 0).bit_length()) * ACCEPT_KEY_BYTES
    sort_scratch = (torch.empty(sort_bytes, dtype=torch.uint8, device=dev)
                    if sort_bytes > ACCEPT_SMEM else None)
    if live_out is not None and (_req(live_out, u8, "live_out").shape
                                 != (W,)):
        raise ValueError("walk_accept: live_out is not [W]")
    live = (live_out if live_out is not None
            else torch.empty((W,), dtype=u8, device=dev))
    choice = torch.empty((W,), dtype=i32, device=dev)
    acc = torch.empty((W,), dtype=u8, device=dev)
    pipe = None if future is None else torch.empty((W,), dtype=u8, device=dev)
    rc = load().vtt_walk_accept(
        _ptr(a["ranked"]), _ptr(a["feas_k"]), UM, K, _ptr(a["p_req"]),
        _ptr(a["p_init_req"]), R, _ptr(a["pid_l"]), _ptr(a["cand_s"]),
        _ptr(a["any_feas"]), _ptr(a["grp"]), W, _ptr(a["idle"]), *fut,
        _ptr(a["ntasks"]), _ptr(a["max_tasks"]), N, _ptr(a["eps"]),
        _ptr(a["scalar_slot"]), _ptr(cumcap), _ptr(sort_scratch),
        _ptr(live), _ptr(choice),
        _ptr(acc), _ptr(pipe), *pp, _ptr(self_anti), _stream(),
    )
    _check(rc, "walk_accept")
    count_launch("walk_accept")
    return choice, acc, pipe


# -------------------------------------------------------- apply_commit

def _add_rows(node_plane, queue_plane, sel, node, rows, row_idx, qidx,
              node_sign, queue_sign):
    """Add the selected tasks' requests to a node plane and a queue plane:
    summed per row in float64 (exact for integer requests), each touched
    row rounded and added once."""
    n = node.long()[sel]
    v = rows[row_idx.long()[sel]].double()
    acc_n = torch.zeros(node_plane.shape, dtype=torch.float64,
                        device=node_plane.device)
    acc_n.index_add_(0, n, node_sign * v)
    acc_q = torch.zeros(queue_plane.shape, dtype=torch.float64,
                        device=node_plane.device)
    acc_q.index_add_(0, qidx.long()[sel], queue_sign * v)
    for state, tot in ((node_plane, acc_n), (queue_plane, acc_q)):
        touched = tot != 0
        state[touched] = state[touched] + tot[touched].to(torch.float32)


def _or_rows(plane, nodes, bits):
    """plane[nodes[i]] |= bits[i] for int32 bit words, duplicates allowed
    (OR is order-free)."""
    if not nodes.numel():
        return
    sh = torch.arange(32, dtype=torch.int32, device=plane.device)
    b = (bits[:, :, None] >> sh) & 1  # [S, PW, 32]
    acc = torch.zeros((plane.shape[0], *b.shape[1:]), dtype=torch.int32,
                      device=plane.device)
    acc.scatter_reduce_(0, nodes.long()[:, None, None].expand_as(b), b,
                        reduce="amax")
    # Distinct bits: the int32 sum carries nothing, so it is the word.
    plane |= (acc << sh).sum(dim=-1).to(torch.int32)


def _count_rows(cw, counts, nodes, rows):
    """cw[e, node_dom[n, term_key[e]]] += 1 for every task (n = nodes[i],
    its profile rows[i]) whose profile matches term e, where the node has
    a domain (wave.py:2043-2130)."""
    if not nodes.numel():
        return
    E, D = cw.shape
    dw = counts.node_dom.long()[nodes.long()[:, None],
                                counts.term_key.long()[None, :]]
    inc = counts.t_matches[rows.long()] & (dw >= 0)
    key = torch.arange(E, device=cw.device)[None, :] * D + dw.clamp(min=0)
    cw.view(-1).index_add_(0, key[inc], torch.ones_like(
        key[inc], dtype=torch.int32))


def _apply_plain(node, mask, rows, row_idx, qidx, idle_sign, mode, jw, idle,
                 q_alloc, ntasks, alloc_l, assigned, pipe=None, pip=None,
                 ports=None, counts=None):
    if pipe is not None:
        psel = pipe.nonzero().squeeze(1)
        _add_rows(pip["pip_extra"], pip["q_pip"], psel, node, rows, row_idx,
                  qidx, 1.0, 1.0)
        pip["pip_ntasks"].index_add_(
            0, node.long()[psel], torch.ones_like(psel, dtype=torch.int32))
        pip["pipelined"][psel] = node[psel]
        if ports is not None:
            _or_rows(ports.pip, node[psel], ports.prof[row_idx.long()[psel]])
        if counts is not None:
            _count_rows(counts.cnt_p, counts, node[psel], row_idx[psel])
    sel = mask.nonzero().squeeze(1)
    n = node.long()[sel]
    _add_rows(idle, q_alloc, sel, node, rows, row_idx, qidx,
              float(idle_sign), -float(idle_sign))
    if mode == 0:
        one = torch.ones_like(n, dtype=torch.int32)
        ntasks.index_add_(0, n, one)
        alloc_l.index_add_(0, jw.long()[sel], one)
        assigned[sel] = node[sel]
        if ports is not None:
            _or_rows(ports.node, node[sel], ports.prof[row_idx.long()[sel]])
        if counts is not None:
            _count_rows(counts.cnt_a, counts, node[sel], row_idx[sel])
    else:
        assigned[sel] = -1


def window_match_terms(t_matches: torch.Tensor) -> torch.Tensor:
    """[UM, EW] int32: each profile row's matched window terms (the True
    columns of ``t_matches``) in ascending order, then -1 -- the term
    lists ``apply_commit`` walks (built once per wave, on the device)."""
    m = t_matches.to(torch.bool)
    order = torch.sort((~m).to(torch.int8), dim=1, stable=True).indices
    hit = torch.gather(m, 1, order)
    return torch.where(hit, order, torch.full_like(order, -1)).to(
        torch.int32).contiguous()


def commit_scratch(N: int, R: int, Q: int, dev):
    """``apply_commit``'s zeroed scratch: float64 accumulators [N, R] and
    [Q, R] (one pair for the commits, another for pipelined charges)."""
    return (torch.zeros((N, R), dtype=torch.float64, device=dev),
            torch.zeros((Q, R), dtype=torch.float64, device=dev))


def apply_commit(node, mask, rows, row_idx, qidx, idle, q_alloc, *,
                 mode: int, idle_sign: float, scratch, jw=None,
                 ntasks=None, alloc_l=None, assigned=None, pipe=None,
                 pip=None, ports=None, counts=None, match_terms=None,
                 plain: bool = False) -> None:
    """Commit (``mode=0``: idle -= req, ntasks += 1, q_alloc += req,
    alloc_l[jw] += 1, assigned = node) or discard (``mode=1``: idle +=
    req, q_alloc -= req, assigned = -1) the tasks where ``mask`` holds,
    in place.  Task t's request is ``rows[row_idx[t]]``, its queue
    ``qidx[t]``.  ``scratch`` is the zeroed scratch the kernel leaves
    zeroed again: ``commit_scratch``'s float64 accumulators ``([N, R],
    [Q, R])``.

    ``pipe`` (mode 0, with releasing capacity): the tasks accepted as
    pipelined this sub-round; ``pip`` then holds the planes they charge,
    in place -- ``pip_extra`` [N, R] and ``q_pip`` [Q, R] += req,
    ``pip_ntasks`` [N] += 1, ``pipelined`` [T] = node -- and ``scratch``,
    its own pair of float64 accumulators.

    Mode 0 only: ``ports`` (a ``Ports``: ``prof`` the [UM, PW] ports of
    the rows ``row_idx`` indexes) ORs each committed task's ports into
    ``ports.node`` at its node, a pipelined task's into ``ports.pip``
    (wave.py:2031-2042); ``counts`` (an ``affkernels.AffTerms`` of the
    wave's window) adds one to ``cnt_a`` -- ``cnt_p`` for a pipelined
    task -- at (e, node_dom[node, term_key[e]]) for every window term e
    its profile matches where the node has a domain (wave.py:2043-2130),
    as int32 atomics.  ``match_terms`` (``window_match_terms`` of
    ``counts.t_matches``, built once per wave) lists the terms each
    profile row matches; on the card ``counts`` needs it."""
    if not _on_card(plain, idle, node, mask):
        _apply_plain(node, mask, rows, row_idx, qidx, idle_sign, mode, jw,
                     idle, q_alloc, ntasks, alloc_l, assigned, pipe, pip,
                     ports, counts)
        return
    N, R = idle.shape
    Q = q_alloc.shape[0]
    T = node.shape[0]
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    a = dict(
        node=_req(node, i32, "node"), mask=_req(mask, u8, "mask"),
        rows=_req(rows, f32, "rows"), row_idx=_req(row_idx, i32, "row_idx"),
        qidx=_req(qidx, i32, "qidx"), idle=_req(idle, f32, "idle"),
        q_alloc=_req(q_alloc, f32, "q_alloc"),
        assigned=_req(assigned, i32, "assigned"),
    )
    if mode == 0:
        a.update(jw=_req(jw, i32, "jw"), ntasks=_req(ntasks, i32, "ntasks"),
                 alloc_l=_req(alloc_l, i32, "alloc_l"))
    idle_acc, q_acc = scratch
    _req(idle_acc, torch.float64, "idle scratch")
    _req(q_acc, torch.float64, "queue scratch")
    if idle_acc.shape != (N, R) or q_acc.shape != (Q, R):
        raise ValueError("apply_commit scratch shapes do not match the state")
    if (mask.shape != (T,) or row_idx.shape != (T,) or qidx.shape != (T,)
            or assigned.shape != (T,) or rows.shape[1] != R
            or (mode == 0 and (jw.shape != (T,) or ntasks.shape != (N,)))):
        raise ValueError("apply_commit: inconsistent input shapes")
    pp = [None] * 7
    if pipe is not None:
        if mode != 0:
            raise ValueError("apply_commit: pipelined tasks need mode 0")
        pxe_acc, qp_acc = pip["scratch"]
        pp = [_req(pipe, u8, "pipe"),
              _req(pip["pip_extra"], f32, "pip_extra"),
              _req(pip["pip_ntasks"], i32, "pip_ntasks"),
              _req(pip["q_pip"], f32, "q_pip"),
              _req(pip["pipelined"], i32, "pipelined"),
              _req(pxe_acc, torch.float64, "pip_extra scratch"),
              _req(qp_acc, torch.float64, "q_pip scratch")]
        if (pp[0].shape != (T,) or pp[1].shape != (N, R)
                or pp[2].shape != (N,) or pp[3].shape != (Q, R)
                or pp[4].shape != (T,) or pp[5].shape != (N, R)
                or pp[6].shape != (Q, R)):
            raise ValueError("apply_commit: inconsistent pipelined shapes")
    if mode != 0 and (ports is not None or counts is not None):
        raise ValueError("apply_commit: ports and counts need mode 0")
    UM = rows.shape[0]
    po = _ports_args(ports, UM, N, "apply_commit")
    if ports is not None and pipe is not None and ports.pip is None:
        raise ValueError("apply_commit: pipelined tasks need ports.pip")
    co = (None, 0, None, None, 0, 0, None, None)
    if counts is not None:
        i32c = torch.int32
        Ew, Dw = counts.cnt_a.shape
        nd = _req(counts.node_dom, i32c, "node_dom")
        if (_req(counts.term_key, i32c, "term_key").shape != (Ew,)
                or _req(counts.t_matches, u8, "t_matches").shape
                != (UM, Ew) or nd.shape[0] != N
                or (pipe is not None and (counts.cnt_p is None or _req(
                    counts.cnt_p, i32c, "cnt_p").shape != (Ew, Dw)))):
            raise ValueError("apply_commit: inconsistent count shapes")
        _req(counts.cnt_a, i32c, "cnt_a")
        if match_terms is None:
            raise ValueError("apply_commit: counts on the card need "
                             "match_terms (window_match_terms, once per "
                             "wave)")
        if _req(match_terms, i32c, "match_terms").shape != (UM, Ew):
            raise ValueError("apply_commit: match_terms is not [UM, EW]")
        co = (_ptr(nd), nd.shape[1], _ptr(counts.term_key),
              _ptr(match_terms), Ew, Dw, _ptr(counts.cnt_a),
              _ptr(counts.cnt_p) if pipe is not None else None)
    _capture("apply_commit" + ("" if ports is None and counts is None
                               else ":aff"),
             mode=mode, idle_sign=idle_sign, ports=ports, counts=counts,
             match_terms=match_terms,
             **a, **({} if pipe is None else dict(
                 pipe=pp[0], pip_extra=pp[1], pip_ntasks=pp[2], q_pip=pp[3],
                 pipelined=pp[4])))
    rc = load().vtt_apply_commit(
        _ptr(a["node"]), _ptr(a["mask"]), _ptr(a["rows"]),
        _ptr(a["row_idx"]), _ptr(a["qidx"]), T, R, float(idle_sign),
        int(mode), _ptr(a.get("jw")), _ptr(a["idle"]), _ptr(a["q_alloc"]),
        _ptr(a.get("ntasks")), _ptr(a.get("alloc_l")), _ptr(a["assigned"]),
        _ptr(idle_acc), _ptr(q_acc), *[_ptr(t) for t in pp], *po,
        *co, _stream(),
    )
    _check(rc, "apply_commit")
    count_launch("apply_commit")


# ------------------------------------------------------- victim_scores

PREEMPT = 0
RECLAIM = 1
DESERVED_UNCAPPED = 1.0e30
SHARE_TOL = 1e-6


def victim_scratch_words(V: int, R: int) -> int:
    """int32 words of ``victim_scores``' scratch for V victim rows of R
    slots (csrc/victim_scores.cu: 256 blocks' ten-uint64 reduction slots
    and two [256, 256] count tables, then 12 + R words a row)."""
    return 256 * 10 * 2 + 2 * 256 * 256 + (12 + R) * V


def _queue_share_plain(q_alloc, q_des):
    capped = q_des < DESERVED_UNCAPPED
    ratio = torch.where(capped, q_alloc / torch.clamp(q_des, min=1e-9),
                        torch.zeros_like(q_alloc))
    return ratio.max(dim=-1).values


def _victim_plain(v_ok, v_jprio, v_crank, v_tie, v_queue, v_node, v_req,
                  p_prio, p_queue, q_alloc, q_des, q_rec, mode, N):
    Q = q_alloc.shape[0]
    q_share = _queue_share_plain(q_alloc, q_des)
    vq = v_queue.long().clamp(0, Q - 1)
    same_q = v_queue == p_queue
    ok = v_ok.bool()
    if mode == PREEMPT:
        eligible = ok & same_q & (v_jprio < p_prio)
    else:
        overused = q_share[vq] > torch.tensor(1.0 + SHARE_TOL,
                                              dtype=torch.float32)
        eligible = ok & ~same_q & q_rec.bool()[vq] & overused
    big = torch.iinfo(torch.int32).max
    prio_key = torch.where(eligible, v_jprio.to(torch.int64),
                           torch.full_like(v_jprio, big, dtype=torch.int64))
    # lexsort((tie, -crank, prio_key, ineligible)): stable sorts, least
    # significant key first.
    order = torch.arange(v_ok.shape[0], device=v_ok.device)
    for key in (v_tie.to(torch.int64), -v_crank.to(torch.int64), prio_key,
                (~eligible).to(torch.int64)):
        order = order[torch.sort(key[order], stable=True).indices]
    # Scatter-add of the eligible requests per node, in victim-index order
    # and in f32 (the order XLA's CPU scatter adds in): the k-th victim of
    # every node is added in round k.
    node = v_node.long().clamp(0, N - 1)
    vals = torch.where(eligible[:, None], v_req, torch.zeros_like(v_req))
    by_node = torch.sort(node, stable=True).indices
    sn = node[by_node]
    start = torch.ones_like(sn, dtype=torch.bool)
    start[1:] = sn[1:] != sn[:-1]
    pos = torch.arange(sn.shape[0], device=sn.device)
    seg0 = torch.cummax(torch.where(start, pos, torch.zeros_like(pos)),
                        dim=0).values
    rank = pos - seg0
    evictable = torch.zeros((N, v_req.shape[1]), dtype=torch.float32,
                            device=v_req.device)
    for k in range(int(rank.max()) + 1 if rank.numel() else 0):
        sel = by_node[rank == k]
        evictable[node[sel]] = evictable[node[sel]] + vals[sel]
    return eligible, order.to(torch.int32), evictable, q_share


def victim_scores(v_ok, v_jprio, v_crank, v_tie, v_queue, v_node, v_req,
                  p_prio: int, p_queue: int, q_alloc, q_deserved,
                  q_reclaimable, mode: int, n_nodes: int,
                  plain: bool = False):
    """Victim eligibility, eviction order, evictable plane and queue shares
    (ops/victim.py:82 ``victim_scores``) over V unpadded victim rows:
    ``(eligible [V] bool, order [V] int32, evictable [n_nodes, R] f32,
    q_share [Q] f32)``.  ``v_ok``/``q_reclaimable`` bool, ``v_jprio``,
    ``v_crank`` (any int32: the caller passes a permutation of 0..V-1),
    ``v_tie``, ``v_queue``, ``v_node`` int32 [V], ``v_req`` [V, R] f32,
    ``q_alloc``/``q_deserved`` [Q, R] f32; ``mode`` 0 preempt, 1 reclaim.
    ``order`` equals the JAX function's ``order[:V]``: the JAX caller pads
    V to a power of two with ineligible rows of crank 0 and tie >= V, which
    sort after every real row of crank >= 0.  On the card one cooperative
    launch (csrc/victim_scores.cu) sorts by the key bits that vary."""
    if not _on_card(plain, v_req, q_alloc, v_ok):
        return _victim_plain(v_ok, v_jprio, v_crank, v_tie, v_queue, v_node,
                             v_req, int(p_prio), int(p_queue), q_alloc,
                             q_deserved, q_reclaimable, int(mode),
                             int(n_nodes))
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    a = dict(
        v_ok=_req(v_ok, u8, "v_ok"), v_jprio=_req(v_jprio, i32, "v_jprio"),
        v_crank=_req(v_crank, i32, "v_crank"),
        v_tie=_req(v_tie, i32, "v_tie"),
        v_queue=_req(v_queue, i32, "v_queue"),
        v_node=_req(v_node, i32, "v_node"), v_req=_req(v_req, f32, "v_req"),
        q_alloc=_req(q_alloc, f32, "q_alloc"),
        q_deserved=_req(q_deserved, f32, "q_deserved"),
        q_reclaimable=_req(q_reclaimable, u8, "q_reclaimable"),
    )
    V, R = v_req.shape
    Q = q_alloc.shape[0]
    N = int(n_nodes)
    if R > MAX_R:
        raise ValueError(f"{R} resource slots exceed the kernels' {MAX_R}")
    if (V < 1 or N < 1 or Q < 1 or V >= 1 << 30
            or any(a[k].shape != (V,) for k in (
                "v_ok", "v_jprio", "v_crank", "v_tie", "v_queue", "v_node"))
            or q_deserved.shape != (Q, R)
            or q_reclaimable.shape != (Q,)):
        raise ValueError("victim_scores: inconsistent input shapes")
    _capture("victim_scores", p_prio=int(p_prio), p_queue=int(p_queue),
             mode=int(mode), n_nodes=N, **a)
    dev = v_req.device
    words = victim_scratch_words(V, R)
    scratch = torch.empty(words, dtype=i32, device=dev)
    eligible = torch.empty(V, dtype=u8, device=dev)
    order = torch.empty(V, dtype=i32, device=dev)
    evictable = torch.empty((N, R), dtype=f32, device=dev)
    q_share = torch.empty(Q, dtype=f32, device=dev)
    rc = load().vtt_victim_scores(
        _ptr(a["v_ok"]), _ptr(a["v_jprio"]), _ptr(a["v_crank"]),
        _ptr(a["v_tie"]), _ptr(a["v_queue"]), _ptr(a["v_node"]),
        _ptr(a["v_req"]), V, R, int(p_prio), int(p_queue),
        _ptr(a["q_alloc"]), _ptr(a["q_deserved"]), _ptr(a["q_reclaimable"]),
        Q, int(mode), N, _ptr(scratch), words, _ptr(eligible),
        _ptr(order), _ptr(evictable), _ptr(q_share), _stream(),
    )
    _check(rc, "victim_scores")
    count_launch("victim_scores")
    return eligible, order, evictable, q_share


# --------------------------------------------------------- frag_scores

_FIT_INERT = float(2 ** 30)  # a slot the profile does not request


def _fit_to_i32(x: torch.Tensor) -> torch.Tensor:
    """Non-negative f32 fit counts -> int32 as XLA converts them (and
    ``__float2int_rz``): past INT32_MAX they saturate, where torch's own
    cast is undefined."""
    out = x.clamp(max=2147483520.0).to(torch.int32)
    return torch.where(x >= 2.0 ** 31, torch.full_like(out, 2 ** 31 - 1),
                       out)


def _profile_counts(plane, req, eps):
    """[N, U] f32: per (node, profile) the min over requested slots of
    floor((plane + eps) / max(req, 1e-9)), 2^30 for a slot not requested,
    0 for a profile that requests nothing."""
    requested = req > eps[None, :]  # [U, R]
    per = torch.floor((plane[:, None, :] + eps[None, None, :])
                      / torch.clamp(req, min=1e-9)[None])
    per = torch.where(requested[None], per, torch.full_like(per, _FIT_INERT))
    cnt = per.min(dim=-1).values
    return torch.where(requested.any(dim=-1)[None, :], cnt,
                       torch.zeros_like(cnt))


def _frag_plain(idle, alloc, ready, evictable, prof_req, eps):
    def fit_of(plane):
        cnt = _profile_counts(plane, prof_req, eps)
        return _fit_to_i32(torch.clamp(cnt, min=0.0).max(dim=-1).values)

    fit_now = fit_of(idle)
    fit_freed = fit_of(idle + evictable)
    provisioned = alloc > eps[None, :]
    frac = torch.where(
        provisioned,
        torch.clamp(idle / torch.clamp(alloc, min=1e-9), 0.0, 1.0),
        torch.zeros_like(idle))
    # Summed left to right from 0 (XLA's CPU order for the short R axis).
    acc = torch.zeros(idle.shape[0], dtype=torch.float32,
                      device=idle.device)
    for s in range(idle.shape[1]):
        acc = acc + frac[:, s]
    nprov = torch.clamp(provisioned.sum(dim=-1), min=1).to(torch.float32)
    has_idle = (idle > eps[None, :]).any(dim=-1)
    frag = torch.where(ready & has_idle & (fit_now == 0), acc / nprov,
                       torch.zeros_like(acc))
    return frag, fit_now, fit_freed


def stage_frag(idle, alloc, ready, evictable, prof_req, eps, device):
    """``frag_scores``' six inputs, numpy, in one buffer on ``device``
    (``stage_planes``: for the card one pinned buffer and one asynchronous
    copy), returned as the six views ``frag_scores`` takes: ``idle`` /
    ``alloc`` / ``evictable`` [N, R] f32, ``ready`` [N] bool, ``prof_req``
    [U, R] f32, ``eps`` [R] f32."""
    import numpy as np

    f32 = torch.float32
    arrays = [np.asarray(idle, np.float32), np.asarray(alloc, np.float32),
              np.asarray(ready, np.bool_), np.asarray(evictable, np.float32),
              np.asarray(prof_req, np.float32), np.asarray(eps, np.float32)]
    dtypes = (f32, f32, torch.bool, f32, f32, f32)
    return staged_views(stage_planes(arrays, device),
                        [(dt, a.shape) for dt, a in zip(dtypes, arrays)])


def _frag_rows(out: torch.Tensor):
    """The [3, N] int32 output's rows: (frag as f32, fit_now, fit_freed)."""
    return out[0].view(torch.float32), out[1], out[2]


def frag_scores(idle, alloc, ready, evictable, prof_req, eps,
                plain: bool = False):
    """Fragmentation planes of one starved gang (ops/rebalance.py:61
    ``frag_scores``): ``idle``/``alloc``/``evictable`` [N, R] f32,
    ``ready`` [N] bool, ``prof_req`` [U, R] f32 (all-zero rows inert),
    ``eps`` [R] f32 (each may be a view of one ``stage_frag`` buffer) ->
    ``(frag [N] f32, fit_now [N] int32, fit_freed [N] int32)``, the rows
    of one [3, N] int32 buffer (``frag`` as its f32 bits), so that one copy
    fetches all three."""
    if not _on_card(plain, idle, alloc, prof_req):
        frag, now, freed = _frag_plain(idle, alloc, ready, evictable,
                                       prof_req, eps)
        return _frag_rows(torch.stack([frag.view(torch.int32), now, freed]))
    f32 = torch.float32
    a = dict(idle=_req(idle, f32, "idle"), alloc=_req(alloc, f32, "alloc"),
             ready=_req(ready, torch.bool, "ready"),
             evictable=_req(evictable, f32, "evictable"),
             prof_req=_req(prof_req, f32, "prof_req"),
             eps=_req(eps, f32, "eps"))
    N, R = idle.shape
    U = prof_req.shape[0]
    if R > MAX_R:
        raise ValueError(f"{R} resource slots exceed the kernels' {MAX_R}")
    if (alloc.shape != idle.shape or evictable.shape != idle.shape
            or ready.shape != (N,) or prof_req.shape != (U, R)
            or eps.shape != (R,)):
        raise ValueError("frag_scores: inconsistent input shapes")
    _capture("frag_scores", **a)
    out = torch.empty((3, N), dtype=torch.int32, device=idle.device)
    rc = load().vtt_frag_scores(
        _ptr(a["idle"]), _ptr(a["alloc"]), _ptr(a["ready"]),
        _ptr(a["evictable"]), _ptr(a["prof_req"]), _ptr(a["eps"]), N, U, R,
        _ptr(out[0]), _ptr(out[1]), _ptr(out[2]), _stream())
    _check(rc, "frag_scores")
    count_launch("frag_scores")
    return _frag_rows(out)


# --------------------------------------------- gang_block_fit, fabric_frag

def _block_caps(idle, ready, ntasks, max_tasks, prof_req, eps):
    """The [N, U] int32 capacity of each node for each profile."""
    cap = _profile_counts(idle, prof_req, eps)
    cap = torch.clamp(cap, 0.0, _FIT_INERT)
    slots_left = torch.where(
        max_tasks > 0, torch.clamp(max_tasks - ntasks, min=0).to(torch.float32),
        torch.full_like(idle[:, 0], _FIT_INERT))
    cap = torch.minimum(cap, slots_left[:, None])
    cap = torch.where(ready[:, None], cap, torch.zeros_like(cap))
    return cap.to(torch.int32)


def _block_fit_plain(idle, ready, ntasks, max_tasks, block_id, prof_req,
                     prof_cnt, eps, n_blocks):
    cap = _block_caps(idle, ready, ntasks, max_tasks, prof_req, eps)
    # Segment sum; blockless rows land in the trash row n_blocks, rows past
    # it are dropped (XLA's out-of-range scatter).
    seg = torch.where(block_id >= 0, block_id,
                      torch.full_like(block_id, n_blocks)).long()
    keep = seg <= n_blocks
    cfit = torch.zeros((n_blocks + 1, cap.shape[1]), dtype=torch.int32,
                       device=idle.device)
    cfit.index_add_(0, seg[keep], cap[keep])
    cfit = cfit[:n_blocks]
    cnt = prof_cnt.to(torch.int32)
    whole = (cfit >= cnt[None, :]).all(dim=-1)
    part = torch.minimum(cfit, cnt[None, :]).to(torch.float32)
    score = torch.zeros(n_blocks, dtype=torch.float32, device=idle.device)
    for u in range(part.shape[1]):
        score = score + part[:, u]
    return cfit, whole, score, _fabric_frag_plain(cfit, whole, cnt)


def gang_block_fit(idle, ready, ntasks, max_tasks, block_id, prof_req,
                   prof_cnt, eps, n_blocks: int, plain: bool = False,
                   cluster: int = 0):
    """Whole-gang fit per fabric block (ops/topology.py:179
    ``gang_block_fit``): ``idle`` [N, R] f32, ``ready`` [N] bool,
    ``ntasks``/``max_tasks``/``block_id`` [N] int32 (block -1: blockless),
    ``prof_req`` [U, R] f32, ``prof_cnt`` [U] int32, ``eps`` [R] f32, over
    ``n_blocks`` block rows -> ``(cfit [n_blocks, U] int32, whole
    [n_blocks] bool, score [n_blocks] f32, frag [n_blocks] f32)``, ``frag``
    being ``fabric_frag(cfit, whole, prof_cnt)`` bit for bit (the JAX
    package computes it with a jit of its own; here the same launch
    writes it, ``FUSED["fabric_frag"]`` counting those launches).

    On the card: one launch of one thread-block cluster, which writes every
    output once.  ``cluster`` forces its size (1-16; 0, the default: chosen
    by N); only tests and measurements set it."""
    B = int(n_blocks)
    if not _on_card(plain, idle, prof_req, block_id):
        return _block_fit_plain(idle, ready, ntasks, max_tasks, block_id,
                                prof_req, prof_cnt, eps, B)
    f32, i32 = torch.float32, torch.int32
    a = dict(idle=_req(idle, f32, "idle"),
             ready=_req(ready, torch.bool, "ready"),
             ntasks=_req(ntasks, i32, "ntasks"),
             max_tasks=_req(max_tasks, i32, "max_tasks"),
             block_id=_req(block_id, i32, "block_id"),
             prof_req=_req(prof_req, f32, "prof_req"),
             prof_cnt=_req(prof_cnt, i32, "prof_cnt"),
             eps=_req(eps, f32, "eps"))
    N, R = idle.shape
    U = prof_req.shape[0]
    if R > MAX_R:
        raise ValueError(f"{R} resource slots exceed the kernels' {MAX_R}")
    if not 0 <= cluster <= 16:
        raise ValueError(f"gang_block_fit: cluster size {cluster} not in "
                         f"0-16")
    if (B < 1 or any(a[k].shape != (N,) for k in (
            "ready", "ntasks", "max_tasks", "block_id"))
            or prof_req.shape != (U, R) or prof_cnt.shape != (U,)
            or eps.shape != (R,)):
        raise ValueError("gang_block_fit: inconsistent input shapes")
    _capture("gang_block_fit", n_blocks=B, **a)
    dev = idle.device
    cfit = torch.empty((B, U), dtype=i32, device=dev)
    whole = torch.empty(B, dtype=torch.bool, device=dev)
    score = torch.empty(B, dtype=f32, device=dev)
    frag = torch.empty(B, dtype=f32, device=dev)
    rc = load().vtt_gang_block_fit(
        _ptr(a["idle"]), _ptr(a["ready"]), _ptr(a["ntasks"]),
        _ptr(a["max_tasks"]), _ptr(a["block_id"]), _ptr(a["prof_req"]),
        _ptr(a["prof_cnt"]), _ptr(a["eps"]), N, U, R, B, int(cluster),
        _ptr(cfit), _ptr(whole), _ptr(score), _ptr(frag), _stream())
    _check(rc, "gang_block_fit")
    count_launch("gang_block_fit", fused="fabric_frag")
    return cfit, whole, score, frag


def _fabric_frag_plain(cfit, whole, prof_cnt):
    cnt = prof_cnt.to(torch.float32)
    need = torch.zeros((), dtype=torch.float32, device=cnt.device)
    for u in range(cnt.shape[0]):
        need = need + cnt[u]
    need = torch.clamp(need, min=1.0)
    part = torch.minimum(cfit.to(torch.float32), cnt[None, :])
    acc = torch.zeros(cfit.shape[0], dtype=torch.float32, device=cnt.device)
    for u in range(cfit.shape[1]):
        acc = acc + part[:, u]
    return torch.where(whole, torch.zeros_like(acc), acc / need)


def fabric_frag(cfit, whole, prof_cnt, plain: bool = False):
    """Stranded-partial-block score (ops/topology.py:240 ``fabric_frag``):
    ``cfit`` [B, U] int32, ``whole`` [B] bool, ``prof_cnt`` [U] int32 ->
    ``[B]`` f32, 0 on a whole block, else sum_u min(cfit, cnt) / max(sum
    cnt, 1).  For a caller that holds only ``cfit`` and ``whole``: the
    rebalance planner reads ``gang_block_fit``'s ``frag``, which its launch
    writes."""
    if not _on_card(plain, cfit, whole, prof_cnt):
        return _fabric_frag_plain(cfit, whole, prof_cnt)
    i32 = torch.int32
    a = dict(cfit=_req(cfit, i32, "cfit"),
             whole=_req(whole, torch.bool, "whole"),
             prof_cnt=_req(prof_cnt, i32, "prof_cnt"))
    B, U = cfit.shape
    if whole.shape != (B,) or prof_cnt.shape != (U,):
        raise ValueError("fabric_frag: inconsistent input shapes")
    _capture("fabric_frag", **a)
    out = torch.empty(B, dtype=torch.float32, device=cfit.device)
    rc = load().vtt_fabric_frag(_ptr(a["cfit"]), _ptr(a["whole"]),
                                _ptr(a["prof_cnt"]), B, U, _ptr(out),
                                _stream())
    _check(rc, "fabric_frag")
    count_launch("fabric_frag")
    return out


# ------------------------------------------------------------ seq_solve

SEQ_MAX_PROFILES = 64  # csrc/seq_solve.cu kMaxProfiles
SEQ_TABLE_BYTES = 256 << 20  # the profiles' tables, at most


class SeqScratch(NamedTuple):
    """``seq_solve``'s scratch (csrc/seq_solve.cu): per row the flags,
    profile hash, profile word and head list, the log of changed nodes
    ([2P + 1]), the ``U`` profiles' tables over ``Np`` nodes (N rounded up
    to 32: keys, meta bytes, the kept preferred-affinity sums, and each
    chunk of 32 nodes' maximum key and any-feasible byte), and the term
    lists."""

    flags: torch.Tensor
    hash: torch.Tensor
    pidh: torch.Tensor
    heads: torch.Tensor
    log: torch.Tensor
    U: int
    Np: int
    keys: torch.Tensor
    meta: torch.Tensor
    spref: torch.Tensor
    cmax: torch.Tensor
    cany: torch.Tensor
    rd_e: torch.Tensor
    rd_flag: torch.Tensor
    md_e: torch.Tensor


def seq_scratch(N: int, P: int, E: int, dev) -> SeqScratch:
    """The scratch of a solve of P rows over N nodes and E terms: as many
    profiles (up to 64) as SEQ_TABLE_BYTES of tables hold."""
    Np = -(-max(N, 1) // 32) * 32
    per_profile = 13 * Np + 9 * (Np // 32)
    U = max(0, min(SEQ_MAX_PROFILES, SEQ_TABLE_BYTES // per_profile))
    u8, i32, i64, f32 = torch.uint8, torch.int32, torch.int64, torch.float32

    def e(n, dtype):
        return torch.empty(n, dtype=dtype, device=dev)

    return SeqScratch(
        flags=e(P, u8), hash=e(P, i64), pidh=e(P, i32), heads=e(P, i32),
        log=e(2 * P + 1, i32), U=U, Np=Np, keys=e(U * Np, i64),
        meta=e(U * Np, u8), spref=e(U * Np, f32), cmax=e(U * Np // 32, i64),
        cany=e(U * Np // 32, u8), rd_e=e(E, i32), rd_flag=e(E, u8),
        md_e=e(E, i32))


def _seq_profile_words(x) -> torch.Tensor:
    """[P, W] int32: each row's profile planes (every plane the node loop
    reads of a row), float planes by their bits."""
    P = x.req.shape[0]
    i32 = torch.int32
    planes = [x.req.view(i32), x.init_req.view(i32), x.sel_bits,
              x.aff_bits.reshape(P, -1), x.aff_terms.reshape(P, 1),
              x.tol_bits, x.pref_bits.reshape(P, -1), x.pref_w.view(i32),
              x.ports]
    if x.extra_ok is not None:
        planes.append(x.extra_ok.to(i32))
    if x.extra_score is not None:
        planes.append(x.extra_score.view(i32))
    return torch.cat([t.to(i32) for t in planes], dim=1)


def seq_profiles(x) -> torch.Tensor:
    """The profile of each task row of ``x`` (an ``ops.allocate.SeqInputs``)
    as ``seq_solve``'s kernel gives them when its tables hold
    SEQ_MAX_PROFILES profiles (N up to ~300,000 nodes), [P] int32 (-1:
    none): the plain version of its row pass and profile rounds.  A real
    row that reads no inter-pod term either equals the row before it (which
    has such a row's profile) or is a head; round k takes the first head
    without a profile and gives profile k to every head with equal profile
    planes, for k < SEQ_MAX_PROFILES.  Rows that read terms, padding rows
    and heads past the cap get -1."""
    P = x.req.shape[0]
    words = _seq_profile_words(x)
    reads = (x.t_req_aff | x.t_req_anti | (x.t_soft != 0)).any(dim=1)
    prof = x.real & ~reads
    same = torch.zeros(P, dtype=torch.bool, device=words.device)
    if P > 1:
        same[1:] = (words[1:] == words[:-1]).all(dim=1) & prof[:-1]
    head = prof & ~same
    pid = torch.full((P,), -1, dtype=torch.int32)
    open_heads = torch.nonzero(head).flatten().cpu()
    for k in range(SEQ_MAX_PROFILES):
        if open_heads.numel() == 0:
            break
        eq = (words[open_heads] == words[open_heads[0]]).all(dim=1).cpu()
        pid[open_heads[eq]] = k
        open_heads = open_heads[~eq]
    follow = (prof & ~head).cpu().tolist()
    for t in range(1, P):
        if follow[t]:
            pid[t] = pid[t - 1]
    return pid.to(words.device)


def seq_solve(x, weights, plain: bool = False):
    """The exact sequential allocate solve (ops/allocate.py:201 ``solve``)
    on ``x``, an ``ops.allocate.SeqInputs``: a grid pass that flags and
    hashes the rows, then one persistent block for the whole solve, which
    keeps the node keys of each profile of equal rows (``seq_scratch``)
    and rescores only the nodes the steps changed.  Returns an
    ``AllocResult`` of tensors on the inputs' device (``assigned`` /
    ``pipelined`` [P] int32, ``never_ready`` / ``fit_failed`` [J] bool,
    ``idle`` [N, R], ``q_alloc`` [Q, R] = allocated + pipelined)."""
    from .allocate import LAST_SEQ, AllocResult, _solve_plain

    if not _on_card(plain, x.idle, x.req, x.cnt0):
        return _solve_plain(x, weights)
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    kinds = dict(
        idle=f32, allocatable=f32, releasing=f32, pipelined=f32, ntasks=i32,
        max_tasks=i32, nports=i32, ready=u8, label_bits=i32, taint_bits=i32,
        req=f32, init_req=f32, job=i32, real=u8, ports=i32, sel_bits=i32,
        aff_bits=i32, aff_terms=i32, tol_bits=i32, pref_bits=i32,
        pref_w=f32, queue=i32, min_available=i32, ready_base=i32,
        deserved=f32, q_alloc=f32, eps=f32, scalar_slot=u8, bres=f32,
        node_dom=i32, term_key=i32, cnt0=i32, t_req_aff=u8, t_req_anti=u8,
        t_matches=u8, t_soft=f32, extra_ok=u8, extra_score=f32)
    for k, dtype in kinds.items():
        v = getattr(x, k)
        if v is not None:
            _req(v, dtype, f"seq_solve {k}")
    N, R = x.idle.shape
    P = x.req.shape[0]
    J = x.queue.shape[0]
    Q = x.deserved.shape[0]
    PW, LW, TW = x.nports.shape[1], x.label_bits.shape[1], \
        x.taint_bits.shape[1]
    A, AP = x.aff_bits.shape[1], x.pref_bits.shape[1]
    K = x.node_dom.shape[1]
    E, D = x.cnt0.shape
    if R > MAX_R:
        raise ValueError(f"{R} resource slots exceed the kernels' {MAX_R}")
    if (any(getattr(x, k).shape != (N, R) for k in (
            "allocatable", "releasing", "pipelined"))
            or any(getattr(x, k).shape != (N,) for k in (
                "ntasks", "max_tasks", "ready"))
            or x.tol_bits.shape != (P, TW) or x.sel_bits.shape != (P, LW)
            or x.ports.shape != (P, PW) or x.init_req.shape != (P, R)
            or x.aff_bits.shape != (P, A, LW)
            or x.pref_bits.shape != (P, AP, LW)
            or x.pref_w.shape != (P, AP)
            or any(getattr(x, k).shape != (P,) for k in (
                "job", "real", "aff_terms"))
            or any(getattr(x, k).shape != (J,) for k in (
                "min_available", "ready_base"))
            or x.q_alloc.shape != (Q, R) or x.deserved.shape != (Q, R)
            or x.node_dom.shape[0] != N or x.term_key.shape != (E,)
            or any(getattr(x, k).shape != (P, E) for k in (
                "t_req_aff", "t_req_anti", "t_matches", "t_soft"))
            or any(v is not None and v.shape != (P, N)
                   for v in (x.extra_ok, x.extra_score))):
        raise ValueError("seq_solve: inconsistent input shapes")
    dev = x.idle.device
    if P == 0:
        # Nothing to place: the inputs' state is the result.
        LAST_SEQ["alloc_cnt"] = torch.zeros(J, dtype=i32, device=dev)
        return AllocResult(
            assigned=torch.empty(0, dtype=i32, device=dev),
            pipelined=torch.empty(0, dtype=i32, device=dev),
            never_ready=torch.zeros(J, dtype=u8, device=dev),
            fit_failed=torch.zeros(J, dtype=u8, device=dev),
            idle=x.idle.clone(), q_alloc=x.q_alloc.clone())
    if J == 0:
        raise ValueError("seq_solve: task rows without jobs")
    _capture("seq_solve", x=x, weights=weights)
    idle = torch.empty_like(x.idle)
    pxe = torch.empty_like(x.idle)
    ntasks = torch.empty_like(x.ntasks)
    pnt = torch.empty_like(x.ntasks)
    nports = torch.empty_like(x.nports)
    pports = torch.empty_like(x.nports)
    cnt = torch.empty_like(x.cnt0)
    tot = torch.empty(E, dtype=i32, device=dev)
    q_alloc = torch.empty_like(x.q_alloc)
    q_pip = torch.empty_like(x.q_alloc)
    assigned = torch.empty(P, dtype=i32, device=dev)
    pipelined = torch.empty(P, dtype=i32, device=dev)
    alloc_cnt = torch.empty(J, dtype=i32, device=dev)
    never_ready = torch.empty(J, dtype=u8, device=dev)
    fit_failed = torch.empty(J, dtype=u8, device=dev)
    sc = seq_scratch(N, P, E, dev)
    rc = load().vtt_seq_solve(
        N, R, PW, LW, TW, P, A, AP, J, Q, K, E, D,
        _ptr(x.idle), _ptr(x.allocatable), _ptr(x.releasing),
        _ptr(x.pipelined), _ptr(x.ntasks), _ptr(x.max_tasks),
        _ptr(x.nports), _ptr(x.ready), _ptr(x.label_bits),
        _ptr(x.taint_bits), _ptr(x.req), _ptr(x.init_req), _ptr(x.job),
        _ptr(x.real), _ptr(x.ports), _ptr(x.sel_bits), _ptr(x.aff_bits),
        _ptr(x.aff_terms), _ptr(x.tol_bits), _ptr(x.pref_bits),
        _ptr(x.pref_w), _ptr(x.queue), _ptr(x.min_available),
        _ptr(x.ready_base), _ptr(x.deserved), _ptr(x.q_alloc),
        _ptr(x.eps), _ptr(x.scalar_slot), _ptr(x.bres),
        *_weights(weights), float(weights.node_affinity_weight),
        _ptr(x.node_dom), _ptr(x.term_key), _ptr(x.cnt0),
        _ptr(x.t_req_aff), _ptr(x.t_req_anti), _ptr(x.t_matches),
        _ptr(x.t_soft), _ptr(x.extra_ok), _ptr(x.extra_score),
        _ptr(idle), _ptr(pxe), _ptr(ntasks), _ptr(pnt), _ptr(nports),
        _ptr(pports), _ptr(cnt), _ptr(tot), _ptr(q_alloc), _ptr(q_pip),
        _ptr(assigned), _ptr(pipelined), _ptr(alloc_cnt), _ptr(never_ready),
        _ptr(fit_failed), _ptr(sc.flags), _ptr(sc.hash), _ptr(sc.pidh),
        _ptr(sc.heads), _ptr(sc.log), sc.U, sc.Np, _ptr(sc.keys),
        _ptr(sc.meta), _ptr(sc.spref), _ptr(sc.cmax), _ptr(sc.cany),
        _ptr(sc.rd_e), _ptr(sc.rd_flag), _ptr(sc.md_e), _stream(),
    )
    _check(rc, "seq_solve")
    count_launch("seq_solve")
    LAST_SEQ["alloc_cnt"] = alloc_cnt
    # The kernel's per-row profile words (a head's profile, -1 none, -2 the
    # row before's), for tests against ``seq_profiles``.
    LAST_SEQ["pidh"] = sc.pidh
    return AllocResult(assigned=assigned, pipelined=pipelined,
                       never_ready=never_ready, fit_failed=fit_failed,
                       idle=idle, q_alloc=q_alloc)
