"""The port's out-of-core data path against the reference's.

``bin_block_stream`` on the same row file as the JAX package's (float32,
bfloat16 and uint8 files, int8 passed through, ``start_row``, the
remainder policies), ``quantize_file_i8`` byte for byte, ``window_stream``'s
windows and ragged tail, ``prefetch_stream``'s order, error propagation,
early close and counters, and the native reader against its numpy
fallback.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu.data import bin_stream as jbs
from distributed_eigenspaces_tpu.runtime import native as jnative
from distributed_eigenspaces_tpu_torch.data import bin_stream as tbs
from distributed_eigenspaces_tpu_torch.runtime import native as tnative
from distributed_eigenspaces_tpu_torch.runtime import prefetch as tpf

D, M, N = 12, 3, 5
STEP = M * N


def _rows(n_rows, seed=0):
    return np.random.default_rng(seed).standard_normal((n_rows, D)).astype(np.float32)


def _file(tmp_path, data, name="rows.bin"):
    path = str(tmp_path / name)
    tbs.write_rows(path, data)
    return path


def _same(port_blocks, jax_blocks):
    assert len(port_blocks) == len(jax_blocks)
    for p, j in zip(port_blocks, jax_blocks):
        j = np.asarray(j)
        assert tuple(p.shape) == j.shape == (M, N, D)
        np.testing.assert_array_equal(p.float().numpy(), j.astype(np.float32))


CASES = [
    # (name, n_rows, kw)
    ("exact", 4 * STEP, {}),
    ("drop_tail", 4 * STEP + 7, {}),
    ("pad_tail", 4 * STEP + 7, {"remainder": "pad"}),
    ("capped", 6 * STEP, {"num_steps": 3}),
    ("start_row", 6 * STEP, {"start_row": 2 * STEP}),
    ("start_row_capped_pad", 6 * STEP + 4, {"start_row": 3 * STEP, "num_steps": 5,
                                            "remainder": "pad"}),
]


@pytest.mark.parametrize("name,n_rows,kw", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("fmt", ["float32", "bfloat16", "uint8", "int8"])
def test_bin_block_stream_matches_the_reference(fmt, name, n_rows, kw, tmp_path):
    x = _rows(n_rows)
    if fmt == "bfloat16":
        stored, jdt = torch.from_numpy(x).to(torch.bfloat16), jnp.bfloat16
    elif fmt == "uint8":
        stored, jdt = np.clip(np.abs(x) * 60, 0, 255).astype(np.uint8), np.uint8
    elif fmt == "int8":
        stored, jdt = np.clip(np.round(x * 40), -127, 127).astype(np.int8), np.int8
    else:
        stored, jdt = x, np.float32
    path = _file(tmp_path, stored)
    out = {"int8": (torch.int8, jnp.int8)}.get(fmt, (torch.float32, jnp.float32))
    common = dict(dim=D, num_workers=M, rows_per_worker=N, dtype=jdt, **kw)
    got = list(tbs.bin_block_stream(path, out_dtype=out[0], **common))
    want = list(jbs.bin_block_stream(path, out_dtype=out[1], **common))
    _same(got, want)
    assert all(b.dtype == out[0] and b.device.type == "cpu" for b in got)


def test_bf16_out_dtype_and_int8_passthrough_keep_bytes(tmp_path):
    x = _rows(2 * STEP)
    path = _file(tmp_path, x)
    got = list(tbs.bin_block_stream(path, dim=D, num_workers=M, rows_per_worker=N,
                                    out_dtype=torch.bfloat16))
    want = list(jbs.bin_block_stream(path, dim=D, num_workers=M, rows_per_worker=N,
                                     out_dtype=jnp.bfloat16))
    _same(got, want)
    q = np.clip(np.round(x * 30), -127, 127).astype(np.int8)
    qpath = _file(tmp_path, q, "rows.i8")
    blocks = list(tbs.bin_block_stream(qpath, dim=D, num_workers=M, rows_per_worker=N,
                                       dtype=np.int8, out_dtype=torch.int8))
    assert np.array_equal(torch.cat([b.reshape(-1, D) for b in blocks]).numpy(), q)


def test_bin_block_stream_rejects_like_the_reference(tmp_path):
    path = _file(tmp_path, _rows(4 * STEP))
    kw = dict(dim=D, num_workers=M, rows_per_worker=N)
    for mod, i8 in ((tbs, torch.int8), (jbs, jnp.int8)):
        with pytest.raises(ValueError, match="step boundary"):
            list(mod.bin_block_stream(path, start_row=STEP + 1, **kw))
        with pytest.raises(ValueError, match="same on-disk dtype"):
            list(mod.bin_block_stream(path, out_dtype=i8, **kw))
        with pytest.raises(ValueError, match="remainder"):
            list(mod.bin_block_stream(path, remainder="wrap", **kw))
        with pytest.raises(ValueError, match="one step needs"):
            list(mod.bin_block_stream(path, dim=D, num_workers=M, rows_per_worker=100))
    tail = _file(tmp_path, _rows(STEP + 3), "tail.bin")
    with pytest.raises(ValueError, match="remainder rows"):
        list(tbs.bin_block_stream(tail, remainder="error", **kw))
    for mod in (tbs, jbs):  # the multi-host read's refusals
        with pytest.raises(ValueError, match="worker_range"):
            list(mod.bin_block_stream(path, worker_range=(1, 1), **kw))
        with pytest.raises(ValueError, match="remainder='drop' only"):
            list(mod.bin_block_stream(path, worker_range=(0, 1), remainder="pad", **kw))
    bad = str(tmp_path / "bad.bin")
    np.zeros(D * 3 + 1, np.float32).tofile(bad)
    with pytest.raises(ValueError, match="whole number"):
        tbs.num_rows(bad, D)


@pytest.mark.parametrize("scale", [None, 12.5])
def test_quantize_file_i8_matches_the_reference(scale, tmp_path):
    x = _rows(1000) * 3.0
    src = _file(tmp_path, x)
    got = tbs.quantize_file_i8(src, str(tmp_path / "p.i8"), dim=D, chunk_rows=77,
                               scale=scale)
    want = jbs.quantize_file_i8(src, str(tmp_path / "j.i8"), dim=D, chunk_rows=77,
                                scale=scale)
    assert got == want and got[1] == 1000
    assert (tmp_path / "p.i8").read_bytes() == (tmp_path / "j.i8").read_bytes()


@pytest.mark.parametrize("n_blocks,window", [(7, 3), (6, 3), (2, 5), (5, 1)])
def test_window_stream_shapes_and_ragged_tail(n_blocks, window):
    blocks = [torch.full((M, N, D), float(i)) for i in range(n_blocks)]
    windows = list(tbs.window_stream(iter(blocks), window))
    sizes = [w.shape[0] for w in windows]
    assert sizes == [window] * (n_blocks // window) + (
        [n_blocks % window] if n_blocks % window else [])
    assert torch.equal(torch.cat(windows), torch.stack(blocks))
    jsizes = [w.shape[0] for w in jbs.window_stream(
        (np.asarray(b) for b in blocks), window)]
    assert sizes == jsizes
    with pytest.raises(ValueError, match="window"):
        list(tbs.window_stream(iter(blocks), 0))


def test_window_stream_keeps_int8():
    blocks = [torch.ones((M, N, D), dtype=torch.int8) for _ in range(3)]
    assert all(w.dtype == torch.int8 for w in tbs.window_stream(blocks, 2))


# -- prefetch ----------------------------------------------------------------


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "det-prefetch" and t.is_alive()]


def test_prefetch_keeps_order_and_counts():
    stats = tpf.PrefetchStats()
    got = list(tpf.prefetch_stream(iter(range(20)), depth=3, stats=stats, device="cpu",
                                   place=lambda i: i * 2))
    assert got == [2 * i for i in range(20)]
    d = stats.as_dict()
    assert d["depth"] == 3 and d["yields"] == 20 and d["wait_s"] >= 0.0
    assert d["verdict"] in ("ingest_bound", "compute_bound")
    blocks = [torch.full((2, 2), float(i)) for i in range(4)]
    placed = list(tpf.prefetch_stream(iter(blocks), device="cpu"))
    assert all(torch.equal(a, b) for a, b in zip(placed, blocks))


def test_prefetch_counts_stalls_on_a_slow_producer():
    def slow():
        for i in range(4):
            time.sleep(0.05)
            yield i

    stats = tpf.PrefetchStats()
    assert list(tpf.prefetch_stream(slow(), depth=2, stats=stats, device="cpu")) == [0, 1, 2, 3]
    assert stats.stalls >= 3 and stats.wait_s >= 0.1
    assert stats.as_dict()["verdict"] == "ingest_bound"


def test_prefetch_raises_the_producers_error_where_it_happened():
    def broken():
        yield 1
        yield 2
        raise OSError("disk gone")

    it = tpf.prefetch_stream(broken(), depth=1, device="cpu")
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    with pytest.raises(ValueError, match="depth"):
        tpf.prefetch_stream(iter([]), depth=0, device="cpu")


def test_prefetch_close_stops_the_producer():
    pulled = []

    def endless():
        i = 0
        while True:
            pulled.append(i)
            yield i
            i += 1

    before = len(_prefetch_threads())
    it = tpf.prefetch_stream(endless(), depth=2, device="cpu")
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    deadline = time.time() + 2.0
    while len(_prefetch_threads()) > before and time.time() < deadline:
        time.sleep(0.01)
    assert len(_prefetch_threads()) == before
    n = len(pulled)
    time.sleep(0.3)
    assert len(pulled) == n <= 3 + 2 + 1  # read ahead by at most depth + 1


def test_prefetch_default_place_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tpf.prefetch_stream(iter([1]))


# -- the native reader -------------------------------------------------------


def test_native_builds_here():
    assert tnative.native_available()
    assert tnative.BUILD_DIR.name == "native" and tnative.BUILD_DIR.parent.name == "build"
    assert any(tnative.BUILD_DIR.glob("det_loader-*.so"))


@pytest.mark.parametrize("chunk,offset,skip", [(64, 0, 0), (100, 12, 0), (48, 4, 20),
                                               (4096, 0, 0), (7, 3, 5)])
def test_native_and_numpy_readers_give_equal_bytes(chunk, offset, skip, tmp_path,
                                                   monkeypatch):
    raw = np.random.default_rng(1).integers(0, 256, 1000, dtype=np.uint8)
    path = str(tmp_path / "raw.bin")
    raw.tofile(path)
    with tnative.ChunkReader(path, chunk, offset=offset, skip=skip) as rd:
        native = list(rd)
    with jnative.ChunkReader(path, chunk, offset=offset, skip=skip) as rd:
        reference = list(rd)
    monkeypatch.setattr(tnative, "_load", lambda: None)
    with tnative.ChunkReader(path, chunk, offset=offset, skip=skip) as rd:
        fallback = list(rd)
    assert native == fallback == reference
    assert b"".join(native)[:chunk] == raw.tobytes()[offset:offset + chunk]


def test_native_kernels_equal_their_fallbacks(monkeypatch):
    x = (np.random.default_rng(2).standard_normal(3 << 20) * 5).astype(np.float32)
    u = np.random.default_rng(3).integers(0, 256, 3 << 20, dtype=np.uint8)
    native = (tnative.absmax_f32(x), tnative.quantize_i8(x, 127 / 30.0), tnative.to_f32(u))
    assert native[0] == jnative.absmax_f32(x)
    assert np.array_equal(native[1], jnative.quantize_i8(x, 127 / 30.0))
    monkeypatch.setattr(tnative, "_load", lambda: None)
    fallback = (tnative.absmax_f32(x), tnative.quantize_i8(x, 127 / 30.0), tnative.to_f32(u))
    assert native[0] == fallback[0]
    # rounding differs only at exact halves: half away from zero natively,
    # half to even in numpy
    diff = native[1].astype(np.int16) - fallback[1]
    halves = np.abs(x * np.float32(127 / 30.0) % 1 - 0.5) == 0
    assert np.all((diff == 0) | halves)
    assert np.array_equal(native[2], fallback[2])


@pytest.mark.parametrize("no_native", ["0", "1"])
def test_failed_native_build_is_said_once(no_native, tmp_path, monkeypatch, capsys):
    """A broken build falls back to numpy with one log line on stderr;
    ``DET_NO_NATIVE=1`` falls back silently."""
    import subprocess

    def broken_gxx(*a, **k):
        raise subprocess.CalledProcessError(1, "g++", stderr=b"loader.cc: error: broken")

    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_LIB_FAILED", False)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(tnative.subprocess, "run", broken_gxx)
    monkeypatch.setenv("DET_NO_NATIVE", no_native)
    capsys.readouterr()
    assert not tnative.native_available() and not tnative.native_available()
    lines = capsys.readouterr().err.splitlines()
    if no_native == "1":
        assert lines == []
    else:
        assert len(lines) == 1
        assert "numpy fallback" in lines[0] and "broken" in lines[0]


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tnative.ChunkReader(str(tmp_path / "absent.bin"), 64)
    with pytest.raises(ValueError):
        tnative.ChunkReader(str(tmp_path / "absent.bin"), 0)
