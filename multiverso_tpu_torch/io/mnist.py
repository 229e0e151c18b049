"""MNIST idx-format loader (port of ``multiverso_tpu/io/mnist.py``).

BASELINE config 1 trains LogisticRegression on MNIST; the reference's example
downloads it (Applications/LogisticRegression/example/run.sh). The loader
reads idx files already on disk; ``load_real`` falls back to scikit-learn's
bundled digits where there are none, so a machine without scikit-learn
needs the idx files.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

_FILES = {
    "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


def _open(path: str):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    return open(path, "rb")


def _read_idx(path: str) -> np.ndarray:
    with _open(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def available(data_dir: str) -> bool:
    img, lbl = _FILES["train"]
    return any(os.path.exists(os.path.join(data_dir, img) + ext)
               for ext in ("", ".gz"))


def load(data_dir: str, split: str = "train",
         flatten: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images [N, 784] float32 in [0,1], labels [N] int32)."""
    img_name, lbl_name = _FILES[split]
    images = _read_idx(os.path.join(data_dir, img_name)).astype(np.float32) / 255.0
    labels = _read_idx(os.path.join(data_dir, lbl_name)).astype(np.int32)
    if flatten:
        images = images.reshape(len(labels), -1)
    else:
        images = images[..., None]  # NHWC
    return images, labels


def load_real(data_dir: Optional[str] = None):
    """Best REAL handwritten-digit data available (tier-4 convergence runs,
    BASELINE config 1): MNIST idx files when present (``data_dir`` or
    $MV_MNIST_DIR), else scikit-learn's bundled UCI handwritten digits
    (1797 real 8x8 samples — real data, shipped in the image; MNIST itself
    cannot be downloaded in a zero-egress environment).

    Returns dict(x_train, y_train, x_test, y_test, provenance).
    """
    data_dir = data_dir or os.environ.get("MV_MNIST_DIR", "")
    if data_dir and available(data_dir):
        xtr, ytr = load(data_dir, "train")
        xte, yte = load(data_dir, "test")
        return {"x_train": xtr, "y_train": ytr, "x_test": xte,
                "y_test": yte, "provenance": "mnist-idx"}
    from sklearn.datasets import load_digits  # bundled real data
    d = load_digits()
    x = (d.data / 16.0).astype(np.float32)
    y = d.target.astype(np.int32)
    # deterministic 80/20 split, stratified-ish by shuffling with a fixed
    # seed (the dataset is ordered)
    rng = np.random.default_rng(0)
    perm = rng.permutation(len(y))
    x, y = x[perm], y[perm]
    cut = int(0.8 * len(y))
    return {"x_train": x[:cut], "y_train": y[:cut],
            "x_test": x[cut:], "y_test": y[cut:],
            "provenance": "uci-digits-8x8 (sklearn bundled, real)"}
