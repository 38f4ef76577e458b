"""Dataset ingest: the port's copy of exemplar_vae_tpu/data/loaders.py (same
splits, same bits for the same config; numpy only).

``load_dataset(cfg)`` returns the three splits plus a Config updated with
``input_size`` / ``input_type`` / ``dynamic_binarization``; every training
example carries its global index (the exemplar bank and the LOO mask
address exemplars by it). Splits are numpy arrays that the trainer moves to
the device once; binarization and dequantization run on the device
(ops/preprocess.py).

File formats read when present under ``cfg.data_dir``: MNIST/Fashion
idx-ubyte (optionally .gz), Larochelle ``binarized_mnist_{train,valid,
test}.amat``, Omniglot ``chardata.mat``, CelebA as
``celeba_{train,valid,test}.npz`` (key 'x', uint8 NHWC 64x64), or a generic
``{name}.npz`` with keys train_x/val_x/test_x[/labels]. With no files, a
deterministic synthetic set with the same shapes and splits is used
(data/synthetic.py) and ``source='synthetic'``. The JAX package parses IDX
and .amat files with an optional native library; the port uses the numpy
parsers that library falls back to, which give the same arrays.
"""

from __future__ import annotations

import gzip
import os
import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np

from exemplar_vae_tpu_torch.config import Config
from exemplar_vae_tpu_torch.data.synthetic import synthetic_images

# Fixed seed of the one-time Bernoulli binarization of val/test splits of
# dynamically-binarized datasets, so evaluation targets are identical across
# epochs and runs; training data stays gray and is re-sampled per step.
EVAL_BIN_SEED = 777


def binarize_eval_split(x: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """One-time Bernoulli sample of an eval split's gray levels -> float32 0/1."""
    xf = x.astype(np.float32) / 255.0 if x.dtype == np.uint8 else \
        np.asarray(x, np.float32)
    return (rng.random_sample(xf.shape) < xf).astype(np.float32)


class DataSplits(NamedTuple):
    train_x: np.ndarray              # (N, H, W, C) float32 [0,1] or uint8
    train_idx: np.ndarray            # (N,) int32 global indices
    train_labels: Optional[np.ndarray]
    val_x: np.ndarray
    val_labels: Optional[np.ndarray]
    test_x: np.ndarray
    test_labels: Optional[np.ndarray]
    source: str                      # 'real' | 'synthetic'


_META = {
    # name: (input_type, dynamic_binarization, (C, H, W))
    "static_mnist": ("binary", False, (1, 28, 28)),
    "dynamic_mnist": ("binary", True, (1, 28, 28)),
    "fashion_mnist": ("gray", False, (1, 28, 28)),
    "omniglot": ("binary", True, (1, 28, 28)),
    "celeba": ("continuous", False, (3, 64, 64)),
    "synthetic": ("binary", True, (1, 28, 28)),
    "synthetic_gray": ("gray", False, (1, 28, 28)),
    "synthetic_continuous": ("continuous", False, (3, 64, 64)),
}


def dataset_meta(name: str):
    if name not in _META:
        raise ValueError(f"unknown dataset: {name} (know {sorted(_META)})")
    return _META[name]


# --------------------------------------------------------------------------
# file readers
# --------------------------------------------------------------------------

def _read_idx(path):
    """Parse an IDX (MNIST-style) file, optionally gzipped."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    magic, = struct.unpack(">I", data[:4])
    ndim = magic & 0xFF
    dims = struct.unpack(">" + "I" * ndim, data[4:4 + 4 * ndim])
    arr = np.frombuffer(data, np.uint8, offset=4 + 4 * ndim)
    return arr.reshape(dims)


def _find(data_dir, names):
    for n in names:
        for cand in (n, n + ".gz"):
            p = os.path.join(data_dir, cand)
            if os.path.exists(p):
                return p
    return None


def _load_mnist_like(data_dir, prefix):
    """idx-ubyte train/test pair -> (xtr, ytr, xte, yte) or None."""
    tr_x = _find(data_dir, [f"{prefix}train-images-idx3-ubyte",
                            f"{prefix}train-images.idx3-ubyte"])
    tr_y = _find(data_dir, [f"{prefix}train-labels-idx1-ubyte",
                            f"{prefix}train-labels.idx1-ubyte"])
    te_x = _find(data_dir, [f"{prefix}t10k-images-idx3-ubyte",
                            f"{prefix}t10k-images.idx3-ubyte"])
    te_y = _find(data_dir, [f"{prefix}t10k-labels-idx1-ubyte",
                            f"{prefix}t10k-labels.idx1-ubyte"])
    if not (tr_x and te_x):
        return None
    xtr = _read_idx(tr_x).astype(np.float32)[..., None] / 255.0
    xte = _read_idx(te_x).astype(np.float32)[..., None] / 255.0
    ytr = _read_idx(tr_y).astype(np.int32) if tr_y else None
    yte = _read_idx(te_y).astype(np.int32) if te_y else None
    return xtr, ytr, xte, yte


def _load_static_mnist(data_dir):
    """Larochelle fixed-binarization .amat files."""
    paths = [os.path.join(data_dir, f"binarized_mnist_{s}.amat")
             for s in ("train", "valid", "test")]
    if not all(os.path.exists(p) for p in paths):
        return None
    return [np.loadtxt(p, dtype=np.float32).reshape(-1, 784).reshape(
        -1, 28, 28, 1) for p in paths]


def _load_generic_npz(data_dir, name):
    p = os.path.join(data_dir, f"{name}.npz")
    if not os.path.exists(p):
        return None
    z = np.load(p)
    need = ("train_x", "val_x", "test_x")
    if not all(k in z for k in need):
        return None
    return (z["train_x"], z.get("train_labels"), z["val_x"],
            z.get("val_labels"), z["test_x"], z.get("test_labels"))


def _load_omniglot(data_dir):
    p = os.path.join(data_dir, "chardata.mat")
    if not os.path.exists(p):
        return None
    from scipy.io import loadmat
    raw = loadmat(p)

    # chardata.mat stores (784, n) with each image's pixels in column-major
    # order, so each 28x28 image is transposed after a C-order reshape
    def conv(d):
        imgs = d.T.reshape(-1, 28, 28).transpose(0, 2, 1)
        return imgs[..., None].astype(np.float32)
    return conv(raw["data"]), conv(raw["testdata"])


def _load_celeba(data_dir):
    parts = []
    for s in ("train", "valid", "test"):
        p = os.path.join(data_dir, f"celeba_{s}.npz")
        if not os.path.exists(p):
            return None
        parts.append(np.load(p)["x"])
    return parts  # uint8 NHWC


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def load_dataset(cfg: Config):
    """-> (DataSplits, Config with input metadata filled in)."""
    name = cfg.dataset_name
    input_type, dyn_bin, (c, h, w) = dataset_meta(name)
    if cfg.dynamic_binarization_override is not None:
        dyn_bin = cfg.dynamic_binarization_override
    cfg = cfg.replace(input_size=(c, h, w), input_type=input_type,
                      dynamic_binarization=dyn_bin)
    dd = cfg.data_dir

    splits = None
    if name in ("dynamic_mnist", "fashion_mnist"):
        prefix = "fashion-" if name == "fashion_mnist" else ""
        got = (_load_mnist_like(dd, prefix)
               or (_load_mnist_like(os.path.join(dd, name), "")
                   if os.path.isdir(os.path.join(dd, name)) else None))
        if got is not None:
            xtr, ytr, xte, yte = got
            # split by index: xtr[:-0] would be empty
            cut = len(xtr) - cfg.val_set_size
            if cut <= 0:
                raise ValueError(
                    f"val_set_size={cfg.val_set_size} consumes the whole "
                    f"training set ({len(xtr)} examples)")
            splits = (xtr[:cut], (ytr[:cut] if ytr is not None else None),
                      xtr[cut:], (ytr[cut:] if ytr is not None else None),
                      xte, yte, "real")
    elif name == "static_mnist":
        got = _load_static_mnist(dd)
        if got is not None:
            tr, va, te = got
            splits = (tr, None, va, None, te, None, "real")
    elif name == "omniglot":
        got = _load_omniglot(dd)
        if got is not None:
            tr, te = got
            # 1345 validation points, at least 1, at least one training point
            n_val = max(1, min(1345, len(tr) // 10))
            cut = max(1, len(tr) - n_val)
            splits = (tr[:cut], None, tr[cut:], None, te, None, "real")
    elif name == "celeba":
        got = _load_celeba(dd)
        if got is not None:
            tr, va, te = got
            splits = (tr, None, va, None, te, None, "real")

    if splits is None:
        gen = _load_generic_npz(dd, name)
        if gen is not None:
            splits = gen + ("real",)

    if splits is None:
        n_tr = cfg.training_set_size
        n_val, n_te = cfg.val_set_size, cfg.test_set_size
        # stable across processes (hash() is randomized per interpreter)
        x, y = synthetic_images(n_tr + n_val + n_te, h, w, c,
                                seed=1000 + zlib.crc32(name.encode()) % 1000)
        if input_type == "binary" and not dyn_bin:
            rng = np.random.default_rng(7)
            x = (rng.random(x.shape) < x).astype(np.float32)
        if input_type == "continuous":
            x = (x * 255).astype(np.uint8)
        splits = (x[:n_tr], y[:n_tr], x[n_tr:n_tr + n_val],
                  y[n_tr:n_tr + n_val], x[n_tr + n_val:], y[n_tr + n_val:],
                  "synthetic")

    tr_x, tr_y, va_x, va_y, te_x, te_y, source = splits
    tr_x = np.ascontiguousarray(tr_x)
    if input_type == "binary" and dyn_bin:
        # one-time fixed-seed eval binarization: val first, then test, from
        # one stream (the order fixes the bits)
        rng = np.random.RandomState(EVAL_BIN_SEED)
        va_x = binarize_eval_split(va_x, rng)
        te_x = binarize_eval_split(te_x, rng)
    ds = DataSplits(
        train_x=tr_x,
        train_idx=np.arange(len(tr_x), dtype=np.int32),
        train_labels=tr_y,
        val_x=np.ascontiguousarray(va_x), val_labels=va_y,
        test_x=np.ascontiguousarray(te_x), test_labels=te_y,
        source=source,
    )
    return ds, cfg
