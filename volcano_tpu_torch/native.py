"""ctypes loaders of the port's host C++: the reclaim engine
(``csrc/host/vcreclaim.cc``) and the solver service's frame codec
(``csrc/host/vcsnap.cc``).

The reclaim action of the host victim walk (``fastpath_evict.py``) runs its
node walk and its cross-queue round-robin in C++ over the same numpy
buffers the Python bookkeeping reads; the remote solver's wire frames are
packed, parsed and delta-patched in C++ (``cache/snapwire.py``).  This is
host code: each source builds with ``g++ -O2 -shared -fPIC`` on first use
into ``csrc/_build/`` (one library a source, named by the hash of the
source and the flags, so an edited source builds anew) and needs no
``nvcc``.  A failed build raises: there is no quiet fallback.

``VOLCANO_TPU_NO_NATIVE=1`` asks for the Python reclaim walk and the numpy
frame codec instead (``reclaim_lib()`` and ``codec_lib()`` return None;
read at every call).  ``VOLCANO_TPU_VCSNAP`` (read at every call) names a
prebuilt frame codec library, loaded instead of the build and held to the
codec's prototypes (``CODEC_SIGS``): a file that does not load, or lacks
an entry point, raises.
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
CODEC_SOURCE = _CSRC / "host" / "vcsnap.cc"
_BUILD = _CSRC / "_build"
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_CODEC: Optional[ctypes.CDLL] = None
_PREBUILT: dict = {}  # VOLCANO_TPU_VCSNAP path -> its bound library

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


_i32 = ctypes.c_int32
_i64 = ctypes.c_int64
# The frame codec's entry points, in the order of the C prototypes.
# Pointers travel as raw addresses (c_void_p).
CODEC_SIGS = {
    "vcsnap_frame_bytes": (_i64, [_vp, _vp, _i32, _i64]),
    "vcsnap_frame_pack": (None, [_vp, _vp, _vp, _vp, _vp, _i32, _vp, _i64,
                                 _vp]),
    "vcsnap_frame_info": (_i32, [_vp, _i64, _vp, _vp]),
    "vcsnap_frame_unpack": (_i32, [_vp, _i64, _vp, _vp, _vp, _vp, _vp]),
    "vcsnap_delta_check": (_i64, [_vp, _i64, _i64, _i64, _i64, _i64, _i64]),
    "vcsnap_delta_apply": (_i32, [_vp, _i64, _i64, _vp, _i64, _vp, _i64,
                                  _i64, _i64]),
}


def _build(source: Path, what: str) -> Path:
    """Compile ``source`` unless a library of this source and these flags
    is already built; raises on a failed build."""
    h = hashlib.blake2b(digest_size=8)
    h.update(source.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    lib = _BUILD / f"lib{source.stem}_{h.hexdigest()}.so"
    if lib.exists():
        return lib
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        res = subprocess.run(
            [CXX, *CXX_FLAGS, str(source), "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=300,
        )
    except (OSError, subprocess.SubprocessError) as err:
        raise RuntimeError(f"{what} build failed: {err}") from err
    if res.returncode != 0:
        raise RuntimeError(f"{what} build failed\n"
                           + res.stdout.decode(errors="replace"))
    # Concurrent builds each write their own file; the rename is atomic.
    os.replace(tmp, lib)
    return lib


def _bind(path: Path, sigs: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def build() -> Path:
    """Compile the reclaim engine unless a library of this source and
    these flags is already built; raises on a failed build."""
    return _build(SOURCE, "host reclaim engine")


def build_codec() -> Path:
    """Compile the frame codec (as ``build`` the engine)."""
    return _build(CODEC_SOURCE, "frame codec")


def load() -> ctypes.CDLL:
    """Build (if needed) and load the engine; raises on failure."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(build(), SIGS)
    return _LIB


def load_codec() -> ctypes.CDLL:
    """Build (if needed) and load the frame codec, or the prebuilt library
    ``VOLCANO_TPU_VCSNAP`` names; raises on failure."""
    global _CODEC
    override = os.environ.get("VOLCANO_TPU_VCSNAP")
    with _LOCK:
        if override:
            lib = _PREBUILT.get(override)
            if lib is None:
                try:
                    lib = _bind(Path(override), CODEC_SIGS)
                except (OSError, AttributeError) as err:
                    raise RuntimeError(
                        f"VOLCANO_TPU_VCSNAP={override!r} is not a frame "
                        f"codec library: {err}") from err
                _PREBUILT[override] = lib
            return lib
        if _CODEC is None:
            _CODEC = _bind(build_codec(), CODEC_SIGS)
    return _CODEC


def reclaim_lib() -> Optional[ctypes.CDLL]:
    """The loaded engine, or None when ``VOLCANO_TPU_NO_NATIVE`` asks for
    the Python walk.  A failed build raises."""
    if os.environ.get("VOLCANO_TPU_NO_NATIVE"):
        return None
    return load()


def codec_lib() -> Optional[ctypes.CDLL]:
    """The loaded frame codec, or None when ``VOLCANO_TPU_NO_NATIVE`` asks
    for the numpy codec.  A failed build raises."""
    if os.environ.get("VOLCANO_TPU_NO_NATIVE"):
        return None
    return load_codec()
