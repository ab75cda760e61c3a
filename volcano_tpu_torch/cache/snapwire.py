"""Wire codec of the solver service: numpy pytrees <-> one contiguous frame.

The counterpart of the JAX package's ``cache/snapwire.py``.  The scheduler
process ships each cycle's solve inputs to the solver child that owns the
card as a single frame packed by the port's C++ codec
(``csrc/host/vcsnap.cc``, loaded by ``native.codec_lib``), and the
assignment vectors return the same way.  Reads are zero-copy: arrays are
numpy views into the received buffer.

Frames are byte-identical to the JAX package's for the same arrays and
manifest, so a JAX scheduler can drive a port child and the reverse.  The
numpy codec below writes and reads the same bytes; it runs only when
``VOLCANO_TPU_NO_NATIVE=1`` asks for it (read per call).  A codec that
does not build raises: there is no quiet fallback.

Protocol v2 adds two transport layers on top of the frame container:

- **Zero-copy encode**: ``encode_frame_views`` produces the exact byte
  stream of ``encode_frame`` as a list of buffers (small header bytes and
  ``memoryview``s of the array data) for ``socket.sendmsg``.
- **Delta records**: a solve frame may ship only the rows of an array that
  changed since the mirrored base frame the receiver already holds.
  ``diff_rows`` computes the bitwise changed-row ranges (bit identity, so
  -0.0 against 0.0 and NaN payload bits count as changes), and
  ``delta_check`` / ``delta_apply`` validate and scatter a delta payload
  into the mirror, treating the descriptor as hostile until validated.
  The record tags (``REC_*``) are wire format.

A tensor on the card never reaches the wire: ``flatten_tree`` takes CPU
tensors (``tensor.numpy()``) and raises on any other device.
"""

from __future__ import annotations

import ctypes
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..native import codec_lib

# Wire constants and the dtype <-> u8 code table (code = list index; wire
# format, extend append-only).  They mirror csrc/host/vcsnap.cc (kMagic,
# kVersion, kMaxDims, kDtypeSize) and the JAX package's table.
WIRE_MAGIC = 0x4E534356
WIRE_VERSION = 1
WIRE_MAX_DIMS = 8
_DTYPES = [
    np.dtype(np.float32), np.dtype(np.float64), np.dtype(np.int8),
    np.dtype(np.int16), np.dtype(np.int32), np.dtype(np.int64),
    np.dtype(np.uint8), np.dtype(np.uint16), np.dtype(np.uint32),
    np.dtype(np.uint64), np.dtype(np.bool_),
]
_DTYPE_CODE = {dt: i for i, dt in enumerate(_DTYPES)}

# Delta-frame record tags (protocol v2; wire format, extend append-only).
REC_FULL = 0   # the slot's array rides the frame whole
REC_SAME = 1   # the receiver's mirrored base array is current
REC_DELTA = 2  # only changed row ranges ride (descriptor + row payload)


def lib_or_none() -> Optional[ctypes.CDLL]:
    """The C++ codec, or None when ``VOLCANO_TPU_NO_NATIVE`` asks for the
    numpy codec.  A failed build raises."""
    return codec_lib()


def _align8(v: int) -> int:
    return (v + 7) & ~7


def _addr(a: np.ndarray) -> int:
    return a.ctypes.data


def _wire_arrays(arrays: List[np.ndarray]) -> List[np.ndarray]:
    # ascontiguousarray promotes 0-d to 1-d; restore the scalar shape so the
    # roundtrip is exact.
    arrs = [np.ascontiguousarray(a).reshape(np.shape(a)) for a in arrays]
    for a in arrs:
        if a.dtype not in _DTYPE_CODE:
            raise TypeError(f"unsupported wire dtype {a.dtype}")
        if a.ndim > WIRE_MAX_DIMS:
            raise ValueError(f"unsupported wire ndim {a.ndim}")
    return arrs


def encode_frame(arrays: List[np.ndarray], manifest: dict) -> bytes:
    """Pack arrays and a JSON manifest into one frame."""
    lib = lib_or_none()
    if lib is None:
        # The numpy codec: the scatter-gather builder's bytes joined (one
        # Python copy of the layout; the byte-identity tests hold it to
        # the C++ packer).
        _total, parts = encode_frame_views(arrays, manifest)
        return b"".join(bytes(p) for p in parts)
    man = json.dumps(manifest, separators=(",", ":")).encode()
    arrs = _wire_arrays(arrays)
    n = len(arrs)
    dtypes = np.array([_DTYPE_CODE[a.dtype] for a in arrs] or [0], np.uint8)
    ndims = np.array([a.ndim for a in arrs] or [0], np.uint8)
    dims_flat = np.array([d for a in arrs for d in a.shape] or [0], np.int64)
    nbytes = np.array([a.nbytes for a in arrs] or [0], np.int64)
    total = lib.vcsnap_frame_bytes(_addr(ndims), _addr(nbytes), n, len(man))
    out = np.zeros(int(total), np.uint8)
    srcs = np.array([_addr(a) for a in arrs] or [0], np.uint64)
    man_arr = np.frombuffer(man or b"\0", np.uint8)
    lib.vcsnap_frame_pack(
        _addr(dtypes), _addr(ndims), _addr(dims_flat), _addr(nbytes),
        _addr(srcs), n, _addr(man_arr), len(man), _addr(out),
    )
    return out.tobytes()


def _malformed() -> ValueError:
    return ValueError("malformed snapshot frame")


def decode_frame(buf) -> Tuple[dict, List[np.ndarray]]:
    """Parse a frame into (manifest, arrays).  Arrays are zero-copy views
    into ``buf`` and inherit its writability (``bytes`` in, read-only views
    out; the receive path passes a ``bytearray`` so the solver child's
    mirror can patch delta rows in place)."""
    raw = np.frombuffer(buf, np.uint8)
    lib = lib_or_none()
    if lib is not None:
        if not len(raw):
            raise _malformed()
        moff = ctypes.c_int64()
        mlen = ctypes.c_int64()
        n = lib.vcsnap_frame_info(_addr(raw), len(raw),
                                  ctypes.addressof(moff),
                                  ctypes.addressof(mlen))
        # The frame is hostile until unpack validates it: a corrupt count
        # must not size allocations (each array needs >= 24 header and
        # data bytes in a well-formed frame).
        if n < 0 or n > len(raw) // 24 + 1:
            raise _malformed()
        m = max(n, 1)
        dtypes = np.zeros(m, np.uint8)
        ndims = np.zeros(m, np.uint8)
        dims_flat = np.zeros(m * 8, np.int64)
        data_off = np.zeros(m, np.int64)
        nbytes = np.zeros(m, np.int64)
        rc = lib.vcsnap_frame_unpack(
            _addr(raw), len(raw), _addr(dtypes), _addr(ndims),
            _addr(dims_flat), _addr(data_off), _addr(nbytes))
        if rc != 0:
            raise _malformed()
        start = int(moff.value)
        manifest = json.loads(
            bytes(raw[start:start + int(mlen.value)]) or b"{}")
        arrays = []
        for i in range(n):
            dt = _DTYPES[int(dtypes[i])]
            shape = tuple(dims_flat[i * 8:i * 8 + int(ndims[i])].tolist())
            count = int(np.prod(shape, dtype=np.int64))
            arrays.append(np.frombuffer(
                buf, dt, count=count, offset=int(data_off[i])).reshape(shape))
        return manifest, arrays
    # The numpy parser.
    if len(buf) < 16:
        raise _malformed()
    head = np.frombuffer(buf, np.uint32, count=4)
    if int(head[0]) != WIRE_MAGIC or int(head[1]) != WIRE_VERSION:
        raise _malformed()
    n = int(head[2])
    mlen = int(head[3])
    if mlen > len(buf) - 16 or n > len(buf) // 24 + 1:
        raise _malformed()
    manifest = json.loads(bytes(buf[16:16 + mlen]) or b"{}")
    off = _align8(16 + mlen)
    arrays = []
    for _ in range(n):
        if 16 > len(buf) - off:
            raise _malformed()
        dt_code = buf[off]
        nd = buf[off + 1]
        if nd > WIRE_MAX_DIMS or dt_code >= len(_DTYPES):
            raise _malformed()
        if 8 + 8 * nd + 8 > len(buf) - off:
            raise _malformed()
        shape = tuple(np.frombuffer(buf, np.int64, count=nd,
                                    offset=off + 8).tolist())
        nb = int(np.frombuffer(buf, np.int64, count=1,
                               offset=off + 8 + 8 * nd)[0])
        off = _align8(off + 8 + 8 * nd + 8)
        if nb < 0 or nb > len(buf) - off:
            raise _malformed()
        dt = _DTYPES[dt_code]
        # Unbounded Python integers: a hostile dim product cannot wrap.
        count = 1
        for d in shape:
            count *= d
        if min(shape, default=0) < 0 or count * dt.itemsize != nb:
            raise _malformed()
        arrays.append(
            np.frombuffer(buf, dt, count=count, offset=off).reshape(shape))
        off = _align8(off + nb)
    return manifest, arrays


# ------------------------------------------------- zero-copy frame views


def encode_frame_views(arrays: List[np.ndarray],
                       manifest: dict) -> Tuple[int, List]:
    """The exact byte stream of ``encode_frame`` as ``(total_len,
    buffers)`` for scatter-gather sends (``socket.sendmsg``): small header
    and padding ``bytes`` between ``memoryview``s of the array data.  No
    array byte is copied: the caller keeps ``arrays`` alive and unchanged
    until the send completes."""
    man = json.dumps(manifest, separators=(",", ":")).encode()
    arrs = _wire_arrays(arrays)
    n = len(arrs)
    head = np.array([WIRE_MAGIC, WIRE_VERSION, n, len(man)],
                    np.uint32).tobytes() + man
    pad = _align8(len(head)) - len(head)
    parts: List = [head + b"\0" * pad]
    total = len(head) + pad
    for a in arrs:
        hdr = bytearray(8)
        hdr[0] = _DTYPE_CODE[a.dtype]
        hdr[1] = a.ndim
        hdr = bytes(hdr) + np.array(a.shape, np.int64).tobytes() \
            + np.int64(a.nbytes).tobytes()
        hpad = _align8(len(hdr)) - len(hdr)
        parts.append(hdr + b"\0" * hpad)
        total += len(hdr) + hpad
        if a.nbytes:
            parts.append(memoryview(a.reshape(-1).view(np.uint8)))
            total += a.nbytes
        dpad = _align8(a.nbytes) - a.nbytes
        if dpad:
            parts.append(b"\0" * dpad)
            total += dpad
    return total, parts


# ------------------------------------------------------- delta records


def _rows_u8(a: np.ndarray) -> np.ndarray:
    """[rows, row_bytes] uint8 view of a C-contiguous array (bitwise row
    identity)."""
    rows = a.shape[0]
    return a.reshape(rows, -1).view(np.uint8)


def diff_rows(new: np.ndarray, old: np.ndarray) -> Optional[np.ndarray]:
    """Bitwise changed-row ranges of ``new`` against ``old`` (same dtype and
    shape, both C-contiguous, ndim >= 1): an int64 ``[n, 2]`` array of
    half-open ``[start, stop)`` ranges in ascending, non-overlapping order,
    empty when the arrays are bit-identical.  None: not row-diffable
    (shape or dtype drift), the slot ships whole."""
    if new.shape != old.shape or new.dtype != old.dtype or new.ndim < 1:
        return None
    if new.nbytes == 0:
        return np.zeros((0, 2), np.int64)
    neq = (_rows_u8(new) != _rows_u8(old)).any(axis=1)
    changed = np.flatnonzero(neq)
    if not len(changed):
        return np.zeros((0, 2), np.int64)
    breaks = np.flatnonzero(np.diff(changed) > 1)
    starts = np.concatenate(([changed[0]], changed[breaks + 1]))
    stops = np.concatenate((changed[breaks], [changed[-1]])) + 1
    return np.stack([starts, stops], axis=1).astype(np.int64)


def ranges_to_desc(ranges: np.ndarray) -> np.ndarray:
    """Wire descriptor of a delta record: ``[n_ranges, s0, e0, s1, e1,
    ...]`` as int64 (rides the frame as an ordinary wire array)."""
    r = np.asarray(ranges, np.int64).reshape(-1, 2)
    return np.concatenate(([np.int64(len(r))], r.reshape(-1)))


def gather_rows(a: np.ndarray, ranges: np.ndarray) -> np.ndarray:
    """The delta payload: the changed rows of ``a`` concatenated in range
    order as one flat uint8 array."""
    au8 = _rows_u8(a)
    if not len(ranges):
        return np.zeros(0, np.uint8)
    return np.concatenate(
        [au8[int(s):int(e)].reshape(-1) for s, e in ranges])


def delta_check(desc: np.ndarray, rows: int, row_bytes: int,
                payload_bytes: int, mirror_gen: int,
                base_gen: int) -> int:
    """Validate one delta record against the mirror slot it patches.
    Returns the summed payload rows (>= 0), -1 on a malformed descriptor
    (truncated, out of bounds, unsorted / overlapping ranges, payload
    length mismatch), -2 when the receiver's mirror generation is not the
    delta's base (the caller falls back to a full frame, never a stale
    solve).  The descriptor is hostile until this validates it; ``rows`` /
    ``row_bytes`` / ``payload_bytes`` / ``mirror_gen`` are the receiver's
    own and trusted."""
    desc = np.asarray(desc)
    if desc.dtype != np.int64 or desc.ndim != 1:
        return -1
    lib = lib_or_none()
    if lib is not None:
        d = np.ascontiguousarray(desc)
        return int(lib.vcsnap_delta_check(
            _addr(d) if len(d) else 0, len(d), rows, row_bytes,
            payload_bytes, mirror_gen, base_gen))
    if mirror_gen != base_gen:
        return -2
    if len(desc) < 1:
        return -1
    n = int(desc[0])
    # The division form rejects a hostile count without arithmetic on it.
    if n < 0 or n > (len(desc) - 1) // 2:
        return -1
    total = 0
    prev_stop = 0
    for i in range(n):
        s = int(desc[1 + 2 * i])
        e = int(desc[2 + 2 * i])
        # Half-open, strictly ascending, non-overlapping, non-empty, within
        # [0, rows); each bound compared against trusted values directly.
        if s < prev_stop or s >= e or e > rows:
            return -1
        total += e - s
        prev_stop = e
    if row_bytes <= 0:
        return -1 if payload_bytes != 0 else total
    if payload_bytes % row_bytes != 0 \
            or total != payload_bytes // row_bytes:
        return -1
    return total


def delta_apply(dst: np.ndarray, desc: np.ndarray, payload: np.ndarray,
                mirror_gen: int, base_gen: int) -> None:
    """Scatter a validated delta payload into the writable mirror array
    ``dst`` at the descriptor's row ranges.  Raises ``ValueError`` on any
    ``delta_check`` rejection before touching ``dst``."""
    rows = dst.shape[0] if dst.ndim else 0
    row_bytes = dst.nbytes // rows if rows else 0
    payload = np.ascontiguousarray(np.asarray(payload, np.uint8))
    rc = delta_check(desc, rows, row_bytes, len(payload),
                     mirror_gen, base_gen)
    if rc == -2:
        raise ValueError("delta base generation mismatch")
    if rc < 0:
        raise ValueError("malformed delta record")
    lib = lib_or_none()
    if lib is not None:
        d = np.ascontiguousarray(np.asarray(desc, np.int64))
        if lib.vcsnap_delta_apply(
                _addr(_rows_u8(dst)) if dst.nbytes else 0, rows, row_bytes,
                _addr(d), len(d), _addr(payload) if len(payload) else 0,
                len(payload), mirror_gen, base_gen) != 0:
            raise ValueError("malformed delta record")
        return
    du8 = _rows_u8(dst)
    off = 0
    n = int(desc[0])
    for i in range(n):
        s = int(desc[1 + 2 * i])
        e = int(desc[2 + 2 * i])
        nb = (e - s) * row_bytes
        du8[s:e] = payload[off:off + nb].reshape(e - s, row_bytes)
        off += nb


# --------------------------------------------------------------- pytrees


def flatten_tree(obj: Any, arrays: List[np.ndarray]) -> Any:
    """Flatten a solve-input pytree (NamedTuples, numpy arrays, CPU
    tensors, scalars, None, tuples) into a JSON-able spec and an array
    list.  A tensor on another device raises: one must never reach the
    wire."""
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, np.ndarray):
        arrays.append(obj)
        return {"t": "a", "i": len(arrays) - 1}
    if isinstance(obj, torch.Tensor):
        if obj.device.type != "cpu":
            raise ValueError(
                f"a tensor on {obj.device} reached the solver wire; the "
                f"remote path ships host arrays only")
        arrays.append(obj.detach().numpy())
        return {"t": "a", "i": len(arrays) - 1}
    if isinstance(obj, (bool, int, float, str)):
        return {"t": "v", "v": obj}
    if hasattr(obj, "_fields"):  # NamedTuple
        return {
            "t": "nt", "n": type(obj).__name__,
            "f": [flatten_tree(x, arrays) for x in obj],
        }
    if isinstance(obj, (tuple, list)):
        return {"t": "l", "f": [flatten_tree(x, arrays) for x in obj]}
    # numpy scalars and other array-likes
    a = np.asarray(obj)
    arrays.append(a)
    return {"t": "a", "i": len(arrays) - 1}


def unflatten_tree(spec: Any, arrays: List[np.ndarray],
                   registry: Dict[str, type]) -> Any:
    t = spec["t"]
    if t == "none":
        return None
    if t == "a":
        return arrays[spec["i"]]
    if t == "v":
        return spec["v"]
    if t == "nt":
        cls = registry[spec["n"]]
        return cls(*[unflatten_tree(f, arrays, registry)
                     for f in spec["f"]])
    if t == "l":
        return tuple(unflatten_tree(f, arrays, registry)
                     for f in spec["f"])
    raise ValueError(f"bad tree spec node {t!r}")
