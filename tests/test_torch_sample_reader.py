"""Port parity, the LR input layer: ``io/sample_reader.py`` (the five
sample formats, the bsparse writer, ``SampleReader``), ``io/stream.py``,
``io/mnist.py`` and ``utils/async_buffer.py`` of multiverso_tpu_torch
against multiverso_tpu on the same files, exactly (the readers parse the
same text into float32, so every array must be equal)."""

import gzip
import struct

import numpy as np
import pytest

from multiverso_tpu.io import mnist as jmnist
from multiverso_tpu.io import sample_reader as jsr
from multiverso_tpu.io import stream as jstream
from multiverso_tpu.utils.async_buffer import AsyncBuffer as JAsyncBuffer
from multiverso_tpu_torch.io import mnist as tmnist
from multiverso_tpu_torch.io import sample_reader as tsr
from multiverso_tpu_torch.io import stream as tstream
from multiverso_tpu_torch.utils.async_buffer import AsyncBuffer

DIM = 12


def _samples(n=37, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        idx = np.sort(rng.choice(DIM + 3, 4, replace=False))  # some >= DIM
        vals = rng.normal(size=4).round(4)
        rows.append((int(rng.integers(0, 3)), idx, vals,
                     float(rng.uniform(0.5, 2.0)).__round__(3)))
    return rows


def _write(path, fmt, rows):
    if fmt == "bsparse":
        with open(path, "wb") as f:
            for label, idx, _, w in rows:
                jsr.write_bsparse_sample(f, label, idx, w)
        return
    with open(path, "w") as f:
        for label, idx, vals, w in rows:
            head = f"{label}:{w}" if fmt.startswith("weight") else f"{label}"
            if fmt in ("dense", "weight_dense"):
                dense = np.zeros(DIM + 3)
                dense[idx] = vals
                feats = " ".join(str(v) for v in dense)
            else:
                feats = " ".join(f"{i}:{v}" for i, v in zip(idx, vals))
            f.write(f"{head} {feats}\n\n")   # blank lines are skipped


def _batches(mod, path, fmt, batch=8, **kw):
    return list(mod.SampleReader(str(path), DIM, batch, fmt=fmt, **kw))


@pytest.mark.parametrize("fmt", ["libsvm", "dense", "weight",
                                 "weight_dense", "bsparse"])
def test_formats_match_jax(tmp_path, fmt):
    path = tmp_path / f"s.{fmt}"
    _write(path, fmt, _samples())
    assert tsr.FORMATS == jsr.FORMATS
    for kw in ({}, {"drop_remainder": True, "loop_epochs": 2}):
        jb, tb = _batches(jsr, path, fmt, **kw), _batches(tsr, path, fmt,
                                                          **kw)
        assert len(tb) == len(jb) == (5 if not kw else 8)
        for (jx, jy, jk), (tx, ty, tk) in zip(jb, tb):
            assert tx.dtype == np.float32 and ty.dtype == np.int32
            assert np.array_equal(tx, jx) and np.array_equal(ty, jy)
            if jk is None:
                assert tk is None
            else:
                assert tk.dtype == np.int64 and np.array_equal(tk, jk)
    for f, line in (("libsvm", "2 0:1 3:-2 40:7"),
                    ("weight", "2:1.5 0:1 3:-2 40:7"),
                    ("weight_dense", "1:0.5 1 2 3"), ("dense", "0 1 2")):
        jl, jx = jsr.parse_line(line, DIM, f)
        tl, tx = tsr.parse_line(line, DIM, f)
        assert tl == jl and np.array_equal(tx, jx)
    assert tsr.parse_line("   ", DIM, fmt) is None


def test_bsparse_files_cross_packages(tmp_path):
    rows = _samples(20, seed=1)
    paths = {}
    for name, mod in (("jax", jsr), ("torch", tsr)):
        paths[name] = tmp_path / f"{name}.bs"
        with open(paths[name], "wb") as f:
            for label, idx, _, w in rows:
                mod.write_bsparse_sample(f, label, idx, w)
    # byte for byte the same layout
    assert paths["jax"].read_bytes() == paths["torch"].read_bytes()
    for path in paths.values():
        for (jx, jy, jk), (tx, ty, tk) in zip(
                _batches(jsr, path, "bsparse"),
                _batches(tsr, path, "bsparse")):
            assert np.array_equal(tx, jx) and np.array_equal(ty, jy)
            assert np.array_equal(tk, jk)


@pytest.mark.parametrize("bad", ["short_head", "short_keys", "huge_n",
                                 "negative_n"])
def test_bsparse_bad_records_fail_loudly(tmp_path, bad):
    path = tmp_path / "bad.bs"
    with open(path, "wb") as f:
        tsr.write_bsparse_sample(f, 1, [1, 2, 3], 1.0)
        if bad == "short_head":
            f.write(b"\x01\x02\x03")
        elif bad == "short_keys":
            f.write(struct.pack("<qid", 5, 0, 1.0) + b"\x00" * 16)
        else:
            n = 10**9 if bad == "huge_n" else -1
            f.write(struct.pack("<qid", n, 0, 1.0))
    match = {"short_head": "truncated bsparse record header",
             "short_keys": "truncated bsparse key block",
             "huge_n": "implausible key count",
             "negative_n": "implausible key count"}[bad]
    for mod in (jsr, tsr):
        with pytest.raises(ValueError, match=match):
            _batches(mod, path, "bsparse")


def test_unknown_format_and_missing_file(tmp_path):
    with pytest.raises(ValueError, match="unknown sample format"):
        tsr.SampleReader(str(tmp_path / "x"), DIM, 8, fmt="csv")
    with pytest.raises(FileNotFoundError):
        _batches(tsr, tmp_path / "missing.svm", "libsvm")


def test_stream_and_text_reader(tmp_path):
    uri = "file://" + str(tmp_path / "sub" / "f.txt")
    for mod in (jstream, tstream):
        with mod.open_stream(uri, "w") as s:      # makes the parent dir
            s.write(b"a b\nc\n\nlast")
        r = mod.TextReader(uri)
        assert list(r) == ["a b", "c", "", "last"]
        r.close()


def _write_idx(path, arr, gz=False):
    head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    data = head + arr.astype(np.uint8).tobytes()
    if gz:
        with gzip.open(str(path) + ".gz", "wb") as f:
            f.write(data)
    else:
        path.write_bytes(data)


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_idx_loader(tmp_path, gz):
    rng = np.random.default_rng(2)
    for split, n in (("train", 6), ("test", 3)):
        img, lbl = jmnist._FILES[split]
        _write_idx(tmp_path / img, rng.integers(0, 256, (n, 28, 28)), gz)
        _write_idx(tmp_path / lbl, rng.integers(0, 10, n), gz)
    assert tmnist.available(str(tmp_path)) and jmnist.available(str(tmp_path))
    assert not tmnist.available(str(tmp_path / "none"))
    for split in ("train", "test"):
        for flat in (True, False):
            tx, ty = tmnist.load(str(tmp_path), split, flatten=flat)
            jx, jy = jmnist.load(str(tmp_path), split, flatten=flat)
            assert np.array_equal(tx, jx) and np.array_equal(ty, jy)
    t, j = tmnist.load_real(str(tmp_path)), jmnist.load_real(str(tmp_path))
    assert t["provenance"] == j["provenance"] == "mnist-idx"
    assert t["x_train"].shape == (6, 784)


def test_mnist_digits_fallback_matches_jax():
    t, j = tmnist.load_real(None), jmnist.load_real(None)
    assert t["provenance"] == j["provenance"]
    for k in ("x_train", "y_train", "x_test", "y_test"):
        assert np.array_equal(t[k], j[k])


def test_async_buffer_matches_jax():
    """The same fill sequence and version-skip accounting as the JAX
    AsyncBuffer, and a fill error raised at get() then recovered."""
    seen = []
    for cls in (JAsyncBuffer, AsyncBuffer):
        state = {"n": 0, "v": 0, "fail": False}

        def fill():
            if state["fail"]:
                state["fail"] = False
                raise RuntimeError("fill failed")
            state["n"] += 1
            return state["n"]

        buf = cls(fill, version_fn=lambda: state["v"])
        got = [buf.get(), buf.get()]      # 1, then the skipped refill
        state["v"] += 1
        got.append(buf.get())             # the fill after the bump
        got.append(buf.get())
        state["fail"] = True
        state["v"] += 1
        got.append(buf.get())
        with pytest.raises(RuntimeError, match="fill failed"):
            buf.get()
        got.append(buf.get())
        buf.stop()
        assert got == [1, 1, 1, 2, 2, 3], (cls, got)
        seen.append(buf.skipped_fills)
    assert seen[0] == seen[1] > 0
