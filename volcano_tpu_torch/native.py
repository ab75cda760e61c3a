"""ctypes loader of the host reclaim engine (``csrc/host/vcreclaim.cc``).

The reclaim action of the host victim walk (``fastpath_evict.py``) runs its
node walk and its cross-queue round-robin in C++ over the same numpy
buffers the Python bookkeeping reads.  This is host code: it builds with
``g++ -O2 -shared -fPIC`` on first use into ``csrc/_build/`` (a library
named by the hash of the source and the flags, so an edited source builds
anew) and needs no ``nvcc``.  A failed build raises: there is no quiet
fallback.

``VOLCANO_TPU_NO_NATIVE=1`` asks for the Python walk instead
(``reclaim_lib()`` returns None; read at every call).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = _CSRC / "host" / "vcreclaim.cc"
_BUILD = _CSRC / "_build"
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_vp = ctypes.c_void_p
_ll = ctypes.c_longlong
# argtypes of each entry point, in the order of the C prototypes.  The
# context captures every stable pointer once; the per-reclaimer calls take
# raw addresses (c_void_p) to keep ctypes marshalling off a path of tens of
# thousands of calls a cycle.
SIGS = {
    "vcreclaim_ctx_new": (
        _vp, [_vp] * 20 + [_vp, _ll] + [_vp] * 4 + [_ll, _ll, _ll, _ll]
        # n_pipelined n_ntasks n_maxtasks pipe_node j_cnt_pending
        # j_waiting j_version q_version Qn j_prio j_rank p_node total_res
        # job_order job_order_len reclaim_gated
        + [_vp] * 8 + [_ll] + [_vp] * 5 + [_ll, _ll]),
    "vcreclaim_ctx_free": (None, [_vp]),
    "vcreclaim_step": (_ll, [
        _vp, _ll, _ll,  # ctx prow qid
        _vp,  # cursor
        _vp, _vp, _vp, _vp,  # anym feas stat slots
        _vp, _vp, _ll,  # out_evicted out_n max
    ]),
    "vcreclaim_drive_mq": (_ll, [
        _vp, _ll,  # ctx has_pred
        _vp, _ll,  # qs_ids n_queues
        _vp, _vp, _vp, _ll,  # q_create q_uid_rank q_named has_prop
        _vp, _vp,  # q_overused out_q_dropped
        _vp, _ll, _vp,  # job_ids n_jobs job_qslot
        _vp, _vp, _vp,  # task_ptr task_rows task_cursor
        _vp,  # row_maskidx
        _ll,  # n_masks
        _vp, _vp, _vp, _vp, _vp,  # anym feas stat slots initreq ptr arrays
        _vp,  # mask_qids
        _vp,  # mask_cursors
        _vp, _vp, _ll,  # out_evicted out_n max_ev
        _vp, _vp, _vp,  # out_pipe_rows out_pipe_nodes out_n_pipe
        _vp, _vp, _ll,  # out_touched out_n_touched max_touched
        _vp,  # out_yield_job
        _vp,  # out_job_dropped
    ]),
}


def build() -> Path:
    """Compile the engine unless a library of this source and these flags
    is already built; raises on a failed build."""
    h = hashlib.blake2b(digest_size=8)
    h.update(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    lib = _BUILD / f"libvcreclaim_{h.hexdigest()}.so"
    if lib.exists():
        return lib
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        res = subprocess.run(
            [CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=300,
        )
    except (OSError, subprocess.SubprocessError) as err:
        raise RuntimeError(f"host reclaim engine build failed: {err}") \
            from err
    if res.returncode != 0:
        raise RuntimeError("host reclaim engine build failed\n"
                           + res.stdout.decode(errors="replace"))
    # Concurrent builds each write their own file; the rename is atomic.
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """Build (if needed) and load the engine; raises on failure."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in SIGS.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _LIB = lib
    return _LIB


def reclaim_lib() -> Optional[ctypes.CDLL]:
    """The loaded engine, or None when ``VOLCANO_TPU_NO_NATIVE`` asks for
    the Python walk.  A failed build raises."""
    if os.environ.get("VOLCANO_TPU_NO_NATIVE"):
        return None
    return load()
