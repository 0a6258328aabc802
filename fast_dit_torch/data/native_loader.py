"""ctypes binding to the C++ feature-batch loader (counterpart of
`fast_dit_tpu/data/native_loader.py:31-149`).

`native/dataloader.cc`, unchanged, is compiled with g++ at first use into
the port's build directory (`ops/_build.py`'s `BUILD_DIR`, which git
ignores), under a name that carries a hash of the source and the flags; it
is never built into `native/`. A C++ thread pool parses the npy files and
assembles each batch into the caller's buffers behind a bounded in-order
prefetch queue. `NativeFeatureLoader` gives the batches of the port's
`feature_batches`: the same epoch-seeded order, the same per-process
strided shards, full batches only. A failed build raises; nothing falls
back to the Python loader.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from ..ops._build import BUILD_DIR
from .features import FeatureDataset

__all__ = ["build_native_library", "NativeFeatureLoader"]

SOURCE = Path(__file__).resolve().parents[2] / "native" / "dataloader.cc"
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib = None


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libfdt_dataloader-{digest[:12]}.so"


def build_native_library(src: Path = SOURCE) -> Path:
    """Compile `src` into the build directory unless its library is there;
    return the library's path. Raises RuntimeError with g++'s output if the
    build fails."""
    out = _target(src)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(src), "-o", str(tmp)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"the native loader needs g++ to build {src}: {e}") from None
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build the native loader from {src} "
                           f"(rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_native_library()))
        P, I64 = ctypes.POINTER, ctypes.c_int64
        lib.dl_create.restype = ctypes.c_void_p
        lib.dl_create.argtypes = [P(ctypes.c_char_p), P(ctypes.c_char_p), I64, P(I64), I64,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                                  ctypes.c_int]
        lib.dl_sample_shape.restype = ctypes.c_int
        lib.dl_sample_shape.argtypes = [ctypes.c_void_p, P(I64), ctypes.c_int]
        lib.dl_next.restype = ctypes.c_int
        lib.dl_next.argtypes = [ctypes.c_void_p, P(ctypes.c_float), P(ctypes.c_int32),
                                ctypes.c_char_p, ctypes.c_int]
        lib.dl_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class NativeFeatureLoader:
    """Iterate {"x": (B, C, H, W) fp32, "y": (B,) int32} batches of the npy
    pairs of `features_dir` and `labels_dir` through the C++ loader, with
    `feature_batches`' order and sharding (drop_last)."""

    def __init__(self, features_dir: str, labels_dir: str, batch_size: int, *,
                 shuffle: bool = True, seed: int = 0, num_epochs: Optional[int] = 1,
                 process_index: int = 0, process_count: int = 1, prefetch: int = 4,
                 num_threads: int = 8):
        if batch_size % process_count:
            raise ValueError(f"batch {batch_size} is not divisible by {process_count} processes")
        self._lib = _load_lib()
        ds = FeatureDataset(features_dir, labels_dir)
        self._fpaths = [os.path.join(features_dir, f).encode() for f in ds.features_files]
        self._lpaths = [os.path.join(labels_dir, f).encode() for f in ds.labels_files]
        self.local_bs = batch_size // process_count
        self.n = len(ds)
        self.shuffle, self.seed, self.num_epochs = shuffle, seed, num_epochs
        self.process_index, self.process_count = process_index, process_count
        self.prefetch, self.num_threads = prefetch, num_threads

    def _epoch_order(self, epoch: int) -> np.ndarray:
        order = np.arange(self.n, dtype=np.int64)
        if self.shuffle:
            order = np.random.RandomState(self.seed + epoch).permutation(self.n).astype(np.int64)
        local = order[self.process_index::self.process_count]
        usable = (len(local) // self.local_bs) * self.local_bs
        return np.ascontiguousarray(local[:usable])

    def __iter__(self) -> Iterator[dict]:
        lib = self._lib
        n_files = len(self._fpaths)
        paths = ctypes.c_char_p * n_files
        fp, lp = paths(*self._fpaths), paths(*self._lpaths)
        err = ctypes.create_string_buffer(512)
        epoch = 0
        while self.num_epochs is None or epoch < self.num_epochs:
            order = self._epoch_order(epoch)
            handle = lib.dl_create(fp, lp, n_files,
                                   order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                                   len(order), self.local_bs, self.prefetch, self.num_threads,
                                   err, 512)
            if not handle:
                raise RuntimeError(f"native loader init failed: {err.value.decode()}")
            try:
                shape = (ctypes.c_int64 * 8)()
                ndim = lib.dl_sample_shape(handle, shape, 8)
                sample = tuple(int(shape[i]) for i in range(ndim))
                if sample[0] == 1:  # features are stored (1, C, H, W)
                    sample = sample[1:]
                x = np.empty((self.local_bs, *sample), np.float32)
                y = np.empty((self.local_bs,), np.int32)
                while True:
                    rc = lib.dl_next(handle, x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                     y.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), err, 512)
                    if rc == 0:
                        break
                    if rc < 0:
                        raise RuntimeError(f"native loader: {err.value.decode()}")
                    yield {"x": x.copy(), "y": y.copy()}
            finally:
                lib.dl_destroy(handle)
            epoch += 1
