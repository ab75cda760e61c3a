"""The solver service's wire codec (``volcano_tpu_torch/cache/snapwire.py``,
``volcano_tpu_torch/csrc/host/vcsnap.cc``) against the JAX package's.

The ten codec tests of ``tests/test_snapwire.py`` run on the port's codec,
each on the C++ codec and on the numpy codec (``VOLCANO_TPU_NO_NATIVE=1``
or ``lib_or_none`` patched to None, as the JAX tests patch theirs).  Then
the cross-package checks: the port's frames are byte for byte the JAX
package's for the same arrays and manifest on every pair of codecs, each
package decodes the other's frames, and ``delta_check`` / ``delta_apply``
give the JAX verdicts on hostile descriptors.  The codec's build raises
when the source does not compile: there is no quiet numpy fallback.
"""

import numpy as np
import pytest
import torch

from volcano_tpu.cache import snapwire as jsw

from volcano_tpu_torch import native
from volcano_tpu_torch.cache import snapwire as sw


def _cases():
    rng = np.random.RandomState(7)
    return [
        np.arange(12, dtype=np.float32).reshape(3, 4),
        np.array([], np.int16),
        rng.randint(0, 255, (5, 2, 3)).astype(np.uint8),
        np.array(True),  # 0-dim
        rng.standard_normal((7,)).astype(np.float64),
        np.array([[1, -2], [3, 4]], np.int64),
        np.zeros((2, 0, 3), np.int32),  # zero-size middle dim
        rng.randint(0, 2 ** 31, (3, 5)).astype(np.uint32),
        np.array([-1, 0, 1], np.int8),
        np.arange(6, dtype=np.uint16),
        np.arange(4, dtype=np.uint64),
    ]


def _codec(monkeypatch, use_native):
    if not use_native:
        monkeypatch.setattr(sw, "lib_or_none", lambda: None)


# ------------------------------------------- twins of tests/test_snapwire.py


@pytest.mark.parametrize("use_native", [True, False])
def test_roundtrip(monkeypatch, use_native):
    _codec(monkeypatch, use_native)
    arrays = _cases()
    man = {"op": "solve", "k": [1, 2.5, "x"], "wave": None}
    buf = sw.encode_frame(arrays, man)
    m2, arrs2 = sw.decode_frame(buf)
    assert m2 == man
    for a, b in zip(arrays, arrs2):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def test_numpy_codec_layout_byte_identical(monkeypatch):
    arrays = _cases()
    man = {"m": "x"}
    native_frame = sw.encode_frame(arrays, man)
    monkeypatch.setattr(sw, "lib_or_none", lambda: None)
    numpy_frame = sw.encode_frame(arrays, man)
    assert native_frame == numpy_frame
    m, arrs = sw.decode_frame(native_frame)  # numpy parser, native frame
    assert m == man and all(
        np.array_equal(a, b) for a, b in zip(arrays, arrs))


@pytest.mark.parametrize("use_native", [True, False])
def test_malformed_frames_rejected(monkeypatch, use_native):
    _codec(monkeypatch, use_native)
    good = sw.encode_frame([np.arange(4, dtype=np.int32)], {})
    with pytest.raises(ValueError):
        sw.decode_frame(b"nope")
    with pytest.raises(ValueError):
        sw.decode_frame(b"")
    with pytest.raises(ValueError):
        sw.decode_frame(good[:20])  # truncated mid-headers
    with pytest.raises(ValueError):
        sw.decode_frame(b"XXXX" + good[4:])
    # A manifest length past the end of the frame.
    long_man = bytearray(good)
    long_man[12:16] = np.uint32(1 << 30).tobytes()
    with pytest.raises(ValueError):
        sw.decode_frame(bytes(long_man))


def test_tree_flatten_roundtrip():
    from volcano_tpu_torch.ops.allocate import SolveJobs

    arrays: list = []
    tree = sw.flatten_tree(
        (SolveJobs(queue=np.zeros(3, np.int32),
                   min_available=np.ones(3, np.int32),
                   ready_base=np.zeros(3, np.int32)),
         None, 2.5, "s", (np.array([1.0], np.float32),)),
        arrays,
    )
    out = sw.unflatten_tree(tree, arrays, {"SolveJobs": SolveJobs})
    jobs, none_v, f, s, tup = out
    assert isinstance(jobs, SolveJobs) and none_v is None
    assert f == 2.5 and s == "s"
    assert np.array_equal(tup[0], [1.0])


def test_tree_takes_cpu_tensors_and_refuses_others():
    """A CPU tensor rides as its numpy view; a tensor on any other device
    is a bug on the remote path and raises (the meta device stands in for
    the card here)."""
    t = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    arrays: list = []
    spec = sw.flatten_tree((t, np.int64(3)), arrays)
    assert isinstance(arrays[0], np.ndarray)
    assert np.array_equal(arrays[0], t.numpy())
    assert arrays[0].dtype == np.int32 and arrays[1].dtype == np.int64
    j_arrays: list = []
    j_spec = jsw.flatten_tree((t.numpy(), np.int64(3)), j_arrays)
    assert spec == j_spec
    assert sw.encode_frame(arrays, spec) == jsw.encode_frame(j_arrays,
                                                             j_spec)
    with pytest.raises(ValueError, match="reached the solver wire"):
        sw.flatten_tree((torch.empty(3, device="meta"),), [])


@pytest.mark.parametrize("use_native", [True, False])
def test_hostile_count_and_dtype_rejected(monkeypatch, use_native):
    _codec(monkeypatch, use_native)
    evil = np.array([0x4E534356, 1, 0x7FFFFFFF, 0], np.uint32).tobytes()
    with pytest.raises(ValueError):
        sw.decode_frame(evil)
    evil = np.array([0x4E534356, 1, 0xFFFFFFFF, 0], np.uint32).tobytes()
    with pytest.raises(ValueError):
        sw.decode_frame(evil)
    good = bytearray(sw.encode_frame([np.arange(4, dtype=np.int32)], {}))
    good[16] = 200  # dtype code out of range
    with pytest.raises(ValueError):
        sw.decode_frame(bytes(good))
    good[16] = 4
    good[17] = 9  # ndim past the limit
    with pytest.raises(ValueError):
        sw.decode_frame(bytes(good))


@pytest.mark.parametrize("use_native", [True, False])
def test_dims_nbytes_mismatch_rejected(monkeypatch, use_native):
    _codec(monkeypatch, use_native)
    good = bytearray(sw.encode_frame(
        [np.arange(8, dtype=np.int32).reshape(2, 4),
         np.arange(6, dtype=np.int32)], {}))
    d0 = ((16 + len(b"{}") + 7) & ~7) + 8
    assert np.frombuffer(bytes(good[d0:d0 + 8]), np.int64)[0] == 2
    for bad in (4, -1, np.iinfo(np.int64).max):
        good[d0:d0 + 8] = np.int64(bad).tobytes()
        with pytest.raises(ValueError):
            sw.decode_frame(bytes(good))
    # A byte length near INT64_MAX must not wrap a bounds check.
    good[d0:d0 + 8] = np.int64(2).tobytes()
    nb_off = d0 + 16
    good[nb_off:nb_off + 8] = np.int64(np.iinfo(np.int64).max).tobytes()
    with pytest.raises(ValueError):
        sw.decode_frame(bytes(good))


def test_diff_rows_bitwise_identity():
    old = np.zeros((6, 2), np.float64)
    old[3, 0] = np.nan
    new = old.copy()
    assert len(sw.diff_rows(new, old)) == 0  # NaN == NaN bitwise
    new[0, 1] = -0.0
    assert sw.diff_rows(new, old).tolist() == [[0, 1]]
    new[1, 0] = 7.0
    new[5, 1] = 8.0
    assert sw.diff_rows(new, old).tolist() == [[0, 2], [5, 6]]
    assert sw.diff_rows(new, old.astype(np.float32)) is None
    assert sw.diff_rows(new[:5], old) is None


@pytest.mark.parametrize("use_native", [True, False])
def test_delta_check_verdicts(monkeypatch, use_native):
    _codec(monkeypatch, use_native)
    rows, row_bytes = 8, 4
    ok = np.array([2, 1, 3, 5, 6], np.int64)
    assert sw.delta_check(ok, rows, row_bytes, 12, 7, 7) == 3
    assert sw.delta_check(ok, rows, row_bytes, 12, 7, 6) == -2
    assert sw.delta_check(np.array([2, 1, 3], np.int64),
                          rows, row_bytes, 12, 7, 7) == -1
    huge = np.array([np.iinfo(np.int64).max - 1, 1, 3], np.int64)
    assert sw.delta_check(huge, rows, row_bytes, 12, 7, 7) == -1
    assert sw.delta_check(ok, rows, row_bytes, 8, 7, 7) == -1
    assert sw.delta_check(ok, rows, row_bytes, 11, 7, 7) == -1
    for bad in ([2, 1, 4, 3, 6], [2, 5, 6, 1, 3], [1, 2, 2],
                [1, -1, 2], [1, 0, np.iinfo(np.int64).max - 2]):
        n_rows = sum(max(0, int(bad[i + 2]) - int(bad[i + 1]))
                     for i in range(0, 2 * int(bad[0]), 2)
                     ) if bad[0] < 4 else 0
        assert sw.delta_check(np.array(bad, np.int64), rows, row_bytes,
                              n_rows * row_bytes, 7, 7) == -1
    assert sw.delta_check(np.array([0], np.int32), rows, row_bytes,
                          0, 7, 7) == -1
    assert sw.delta_check(np.zeros(0, np.int64), rows, row_bytes,
                          0, 7, 7) == -1
    assert sw.delta_check(np.array([0], np.int64), rows, row_bytes,
                          0, 7, 7) == 0


@pytest.mark.parametrize("use_native", [True, False])
def test_delta_roundtrip_scatter(monkeypatch, use_native):
    _codec(monkeypatch, use_native)
    rng = np.random.RandomState(3)
    for dtype, cols in ((np.float32, 5), (np.int64, 3), (np.uint8, 17)):
        old = rng.randint(0, 200, (64, cols)).astype(dtype)
        new = old.copy()
        for row in (0, 1, 13, 14, 15, 63):
            new[row] = rng.randint(0, 200, cols).astype(dtype)
        r = sw.diff_rows(new, old)
        desc = sw.ranges_to_desc(r)
        payload = sw.gather_rows(new, r)
        mirror = old.copy()
        sw.delta_apply(mirror, desc, payload, 5, 5)
        assert np.array_equal(mirror.view(np.uint8), new.view(np.uint8))
        mirror2 = old.copy()
        with pytest.raises(ValueError):
            sw.delta_apply(mirror2, desc, payload, 5, 4)
        assert np.array_equal(mirror2, old)
        bad = desc.copy()
        bad[0] = np.iinfo(np.int64).max - 1
        with pytest.raises(ValueError):
            sw.delta_apply(mirror2, bad, payload, 5, 5)
        assert np.array_equal(mirror2, old)


@pytest.mark.parametrize("use_native", [True, False])
def test_encode_frame_views_byte_identical(monkeypatch, use_native):
    _codec(monkeypatch, use_native)
    arrays = _cases()
    man = {"op": "solve", "wire": {"gen": 3}, "wave": None}
    ref = sw.encode_frame(arrays, man)
    total, parts = sw.encode_frame_views(arrays, man)
    assert total == len(ref)
    assert b"".join(bytes(p) for p in parts) == ref
    a = np.arange(32, dtype=np.int64)
    _, pv = sw.encode_frame_views([a], {})
    views = [p for p in pv if isinstance(p, memoryview)]
    assert len(views) == 1
    a[0] = 99
    assert bytes(views[0][:8]) == np.int64(99).tobytes()


# ------------------------------------------------- against the JAX codec


@pytest.mark.parametrize("port_native", [True, False])
@pytest.mark.parametrize("jax_native", [True, False])
def test_frames_byte_identical_to_jax(monkeypatch, port_native, jax_native):
    """The port's frames are the JAX package's, byte for byte, on every
    pair of codecs, for arrays, for no arrays and for the reply shape."""
    _codec(monkeypatch, port_native)
    if not jax_native:
        monkeypatch.setattr(jsw, "lib_or_none", lambda: None)
    arrays = _cases()
    for arrs, man in (
            (arrays, {"op": "solve", "k": [1, 2.5, "x"], "wave": None}),
            ([], {"op": "ping"}),
            ([], {}),
            ([np.int32(4), np.zeros((3,), np.bool_)],
             {"op": "result", "ack_gen": 9, "solve_ms": 1.5})):
        port = sw.encode_frame(arrs, man)
        assert port == jsw.encode_frame(arrs, man)
        total, parts = sw.encode_frame_views(arrs, man)
        j_total, j_parts = jsw.encode_frame_views(arrs, man)
        assert total == j_total
        assert b"".join(bytes(p) for p in parts) == \
            b"".join(bytes(p) for p in j_parts)


@pytest.mark.parametrize("use_native", [True, False])
def test_cross_package_decode(monkeypatch, use_native):
    """The JAX parser reads the port's frames and the port's parser reads
    the JAX package's, array for array (views into bytearrays stay
    writable on both sides, as the child's mirror needs)."""
    _codec(monkeypatch, use_native)
    arrays = _cases()
    man = {"op": "solve", "tree": {"t": "none"}}
    for enc, dec in ((sw.encode_frame, jsw.decode_frame),
                     (jsw.encode_frame, sw.decode_frame)):
        buf = bytearray(enc(arrays, man))
        m, out = dec(buf)
        assert m == man
        for a, b in zip(arrays, out):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)
            assert b.flags.writeable


def _hostile_descs():
    big = np.iinfo(np.int64).max
    return [
        [2, 1, 3, 5, 6], [0], [], [1, 0, 8], [1, 0, 9], [1, -1, 2],
        [2, 1, 4, 3, 6], [2, 5, 6, 1, 3], [1, 2, 2], [2, 1, 3],
        [big - 1, 1, 3], [big, 0, 1], [-1, 0, 1], [1, 0, big - 2],
        [1, big - 1, big], [3, 0, 1, 1, 2, 7, 8], [1, -big - 1, 1],
    ]


@pytest.mark.parametrize("use_native", [True, False])
def test_delta_check_and_apply_equal_jax_on_hostile_descriptors(
        monkeypatch, use_native):
    """Verdict for verdict, and mirror byte for mirror byte, the port's
    delta validation and scatter equal the JAX package's native engine on
    valid and hostile descriptors, payload lengths and generations."""
    _codec(monkeypatch, use_native)
    rows, row_bytes = 8, 4
    rng = np.random.RandomState(11)
    base = rng.randint(0, 255, (rows, row_bytes)).astype(np.uint8)
    for d in _hostile_descs():
        desc = np.array(d, np.int64)
        for payload_rows in (0, 1, 2, 3, 7, 8):
            pb = payload_rows * row_bytes
            for gens in ((7, 7), (7, 6)):
                want = jsw.delta_check(desc, rows, row_bytes, pb, *gens)
                got = sw.delta_check(desc, rows, row_bytes, pb, *gens)
                assert got == want, (d, pb, gens)
                payload = rng.randint(0, 255, pb).astype(np.uint8)
                outs = []
                for mod in (jsw, sw):
                    dst = base.copy()
                    try:
                        mod.delta_apply(dst, desc, payload, *gens)
                        outs.append(("ok", dst.tobytes()))
                    except ValueError as e:
                        outs.append((str(e), dst.tobytes()))
                assert outs[0] == outs[1], (d, pb, gens)


# ------------------------------------------------------------- the build


def test_codec_build_failure_raises(monkeypatch, tmp_path):
    """No quiet fallback: a codec source that does not compile raises at
    build and at load, and ``codec_lib`` raises with it; only
    ``VOLCANO_TPU_NO_NATIVE=1`` (read per call) selects the numpy codec."""
    monkeypatch.setattr(native, "_BUILD", tmp_path / "build")
    bad = tmp_path / "vcsnap.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "CODEC_SOURCE", bad)
    monkeypatch.setattr(native, "_CODEC", None)
    with pytest.raises(RuntimeError, match="frame codec build failed"):
        native.build_codec()
    with pytest.raises(RuntimeError, match="build failed"):
        native.codec_lib()
    with pytest.raises(RuntimeError, match="build failed"):
        sw.encode_frame([np.arange(3)], {})
    monkeypatch.setenv("VOLCANO_TPU_NO_NATIVE", "1")
    assert native.codec_lib() is None
    frame = sw.encode_frame([np.arange(3)], {})
    assert frame == jsw.encode_frame([np.arange(3)], {})


def test_codec_build_is_keyed_by_the_source(monkeypatch, tmp_path):
    import subprocess

    calls = []
    real = subprocess.run

    def spy(cmd, *a, **k):
        calls.append(cmd)
        return real(cmd, *a, **k)

    src = tmp_path / "vcsnap.cc"
    src.write_text(native.CODEC_SOURCE.read_text())
    monkeypatch.setattr(native, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "CODEC_SOURCE", src)
    monkeypatch.setattr(native.subprocess, "run", spy)
    lib = native.build_codec()
    assert lib.parent == tmp_path / "build" and lib.exists()
    assert native.build_codec() == lib and len(calls) == 1
    src.write_text(src.read_text() + "\n// edited\n")
    other = native.build_codec()
    assert other != lib and len(calls) == 2


def test_no_native_is_read_at_every_call(monkeypatch):
    assert sw.lib_or_none() is native.load_codec()
    monkeypatch.setenv("VOLCANO_TPU_NO_NATIVE", "1")
    assert sw.lib_or_none() is None
    monkeypatch.delenv("VOLCANO_TPU_NO_NATIVE")
    assert sw.lib_or_none() is native.load_codec()
