"""The port's native ingest (data/native_ingest.py, native/ingest.cc)
against the JAX package's and numpy's parsers: equal arrays on IDX files
of 1-3 dims, gzipped IDX, a non-uint8 IDX (rejected), .amat files with 0/1
and float tokens and the oversized token across the 1 MiB read boundary;
the dataset loaders read through it; a missing compiler or a failed build
raises with its message rather than fall back to numpy."""

import gzip
import struct

import numpy as np
import pytest

from exemplar_vae_tpu.data import native_ingest as j_native
from exemplar_vae_tpu.data.loaders import _read_idx as j_read_idx
from exemplar_vae_tpu_torch.data import native_ingest
from exemplar_vae_tpu_torch.data.loaders import _read_idx


def _write_idx(path, arr, type_byte=0x08):
    with open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, type_byte, arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.tobytes())
    return str(path)


def _numpy_idx(path):
    data = open(path, "rb").read()
    ndim = data[3]
    dims = struct.unpack(">" + "I" * ndim, data[4:4 + 4 * ndim])
    return np.frombuffer(data, np.uint8, offset=4 + 4 * ndim).reshape(dims)


@pytest.mark.parametrize("shape", [(37,), (9, 13), (11, 28, 28)])
def test_idx_matches_jax_and_numpy(shape, tmp_path):
    arr = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    p = _write_idx(tmp_path / "x-idx-ubyte", arr)
    got = native_ingest.load_idx(p)
    assert got.dtype == np.uint8
    for want in (arr, _numpy_idx(p), j_native.load_idx(p), j_read_idx(p)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_read_idx(p), arr)


def test_gzipped_idx_goes_to_the_python_parser(tmp_path):
    arr = np.random.default_rng(2).integers(0, 256, (5, 28, 28), dtype=np.uint8)
    p = _write_idx(tmp_path / "x-idx3-ubyte", arr)
    pg = tmp_path / "x-idx3-ubyte.gz"
    with gzip.open(pg, "wb") as f:
        f.write(open(p, "rb").read())
    assert native_ingest.load_idx(str(pg)) is None
    np.testing.assert_array_equal(_read_idx(str(pg)), arr)
    np.testing.assert_array_equal(_read_idx(str(pg)), j_read_idx(str(pg)))


def test_non_uint8_idx_is_rejected(tmp_path):
    """Type byte 0x0C (int32): the native reader returns None, never 6
    bytes of the 24-byte payload as uint8; the Python parser then raises on
    the payload's size, as the JAX package's does."""
    p = _write_idx(tmp_path / "ints-idx1-int32", np.arange(6, dtype=">i4"),
                   type_byte=0x0C)
    assert native_ingest.load_idx(p) is None
    assert j_native.load_idx(p) is None
    with pytest.raises(ValueError):
        _read_idx(p)
    with pytest.raises(ValueError):
        j_read_idx(p)


def _write_amat(path, arr):
    with open(path, "w") as f:
        for row in arr:
            f.write(" ".join("1" if v else "0" for v in row) + " \n")
    return str(path)


def test_amat_matches_jax_and_numpy(tmp_path):
    arr = (np.random.default_rng(0).random((37, 784)) < 0.3).astype(np.float32)
    p = _write_amat(tmp_path / "binarized_mnist_test.amat", arr)
    got = native_ingest.load_amat(p, n_cols=784)
    assert got.dtype == np.float32
    for want in (arr, np.loadtxt(p, dtype=np.float32).reshape(-1, 784),
                 j_native.load_amat(p, n_cols=784)):
        np.testing.assert_array_equal(got, want)


def test_amat_float_tokens(tmp_path):
    p = tmp_path / "f.amat"
    p.write_text("0.5 1 0.25\n0 0.125 1\n")
    got = native_ingest.load_amat(str(p), n_cols=3)
    np.testing.assert_array_equal(got, [[0.5, 1, 0.25], [0, 0.125, 1]])
    np.testing.assert_array_equal(got, j_native.load_amat(str(p), n_cols=3))


def test_amat_oversized_token_at_the_read_boundary(tmp_path):
    """A 93-character token with 80 characters before the end of the first
    1 MiB read exceeds the parser's 64-byte carry: it reports the file
    malformed (-1) and load_amat parses it with numpy, as the JAX package
    does."""
    p = tmp_path / "long_token.amat"
    long_tok = "0." + "0" * 90 + "1"
    n_lead = ((1 << 20) - 80) // 2
    tail = 3 * ((n_lead + 1) // 3 + 1) - (n_lead + 1)
    p.write_text("0 " * n_lead + long_tok + " " + "1 " * tail)
    native_ingest.build()
    out = np.empty(p.stat().st_size // 2 + 16, np.float32)
    assert native_ingest._lib.amat_parse(
        str(p).encode(), out.ctypes.data_as(
            native_ingest.ctypes.POINTER(native_ingest.ctypes.c_float)),
        out.size) == -1
    got = native_ingest.load_amat(str(p), n_cols=3)
    assert got.shape == ((n_lead + 1 + tail) // 3, 3)
    flat = got.reshape(-1)
    assert flat[n_lead] == pytest.approx(float(long_tok))
    assert flat[:n_lead].sum() == 0 and flat[n_lead + 1:].sum() == tail
    np.testing.assert_array_equal(got, j_native.load_amat(str(p), n_cols=3))


def test_loaders_read_through_the_native_parsers(tmp_path):
    """static_mnist's .amat splits and an MNIST IDX pair load as the JAX
    package's loaders load them."""
    from exemplar_vae_tpu.config import Config as JConfig
    from exemplar_vae_tpu.data.loaders import load_dataset as j_load
    from exemplar_vae_tpu_torch.config import Config
    from exemplar_vae_tpu_torch.data.loaders import load_dataset
    rng = np.random.default_rng(2)
    for split, n in [("train", 40), ("valid", 10), ("test", 10)]:
        _write_amat(tmp_path / f"binarized_mnist_{split}.amat",
                    rng.random((n, 784)) < 0.3)
    for prefix, n in [("train", 30), ("t10k", 10)]:
        _write_idx(tmp_path / f"{prefix}-images-idx3-ubyte",
                   rng.integers(0, 256, (n, 28, 28), dtype=np.uint8))
        _write_idx(tmp_path / f"{prefix}-labels-idx1-ubyte",
                   rng.integers(0, 10, (n,), dtype=np.uint8))
    for name in ("static_mnist", "dynamic_mnist"):
        ds, _ = load_dataset(Config(dataset_name=name, data_dir=str(tmp_path),
                                    val_set_size=5))
        jds, _ = j_load(JConfig(dataset_name=name, data_dir=str(tmp_path),
                                val_set_size=5))
        assert ds.source == jds.source == "real"
        for field in ("train_x", "train_labels", "val_x", "test_x"):
            a, b = getattr(ds, field), getattr(jds, field)
            if b is None:
                assert a is None, field
            else:
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=field)


def _fresh_build(monkeypatch, tmp_path, source=None):
    monkeypatch.setattr(native_ingest, "_lib", None)
    monkeypatch.setattr(native_ingest, "BUILD_DIR", tmp_path / "_build")
    if source is not None:
        monkeypatch.setattr(native_ingest, "SOURCE", source)


def test_build_is_keyed_by_the_source(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    assert native_ingest.build() > 0.0
    (so,) = (tmp_path / "_build").iterdir()
    assert so.name.startswith("libingest_") and so.suffix == ".so"
    assert native_ingest.build() == 0.0


def test_missing_compiler_raises(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_ingest.load_idx(str(tmp_path / "x-idx-ubyte"))


def test_failed_build_raises_with_the_compiler_message(monkeypatch, tmp_path):
    bad = tmp_path / "ingest.cc"
    bad.write_text('extern "C" long idx_parse( {\n')
    _fresh_build(monkeypatch, tmp_path, source=bad)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native_ingest.load_amat(str(tmp_path / "f.amat"))
    assert not any((tmp_path / "_build").iterdir())
