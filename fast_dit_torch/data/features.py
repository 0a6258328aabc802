"""Pre-extracted latent-feature dataset + host-side batcher (the port's
own copy of `fast_dit_tpu/data/features.py:25-119`, numpy only).

Sorted per-sample `{i}.npy` feature/label pairs, a seeded shuffled batcher
with a background prefetch thread (process-local shards by global index),
and the endless synthetic latent batches the trainer's `--synthetic-data`
uses. Batches are numpy; the trainer moves them to the card.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Optional

import numpy as np

__all__ = ["FeatureDataset", "feature_batches", "synthetic_features"]


class FeatureDataset:
    """Sorted `{features_dir}/*.npy` + `{labels_dir}/*.npy` pairs
    (reference train.py:97-116 semantics, including sorted-listdir pairing)."""

    def __init__(self, features_dir: str, labels_dir: str):
        self.features_dir = features_dir
        self.labels_dir = labels_dir
        self.features_files = sorted(os.listdir(features_dir))
        self.labels_files = sorted(os.listdir(labels_dir))
        assert len(self.features_files) == len(self.labels_files), (
            "Number of feature files and label files should be same")

    def __len__(self) -> int:
        return len(self.features_files)

    def __getitem__(self, idx: int):
        f = np.load(os.path.join(self.features_dir, self.features_files[idx]))
        l = np.load(os.path.join(self.labels_dir, self.labels_files[idx]))
        return f, l


def _load_batch(ds: FeatureDataset, idxs: np.ndarray):
    feats, labels = [], []
    for i in idxs:
        f, l = ds[int(i)]
        feats.append(np.squeeze(f, axis=0) if f.ndim == 4 else f)
        labels.append(np.squeeze(l))
    # features arrive (1, 4, H, W) per sample (reference train.py:198 squeeze)
    return {"x": np.stack(feats).astype(np.float32),
            "y": np.stack(labels).astype(np.int32)}


def feature_batches(
    ds: FeatureDataset,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    num_epochs: Optional[int] = None,
    process_index: int = 0,
    process_count: int = 1,
    prefetch: int = 2,
) -> Iterator[dict]:
    """Yield {"x": (B, C, H, W), "y": (B,)} host batches.

    Multi-host: each process reads its global-index stride (epoch-seeded
    shuffle is identical across processes, like DistributedSampler).
    A background thread keeps `prefetch` batches ahead of the consumer.
    """
    assert batch_size % process_count == 0
    local_bs = batch_size // process_count
    n = len(ds)

    def index_stream():
        epoch = 0
        while num_epochs is None or epoch < num_epochs:
            order = np.arange(n)
            if shuffle:
                order = np.random.RandomState(seed + epoch).permutation(n)
            # per-process strided shard of the common order
            local = order[process_index::process_count]
            usable = (len(local) // local_bs) * local_bs if drop_last else len(local)
            for s in range(0, usable, local_bs):
                yield local[s: s + local_bs]
            epoch += 1

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    _SENTINEL = object()

    def worker():
        try:
            for idxs in index_stream():
                q.put(_load_batch(ds, idxs))
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            return
        yield item


def synthetic_features(batch_size: int, *, latent_size: int = 32, channels: int = 4,
                       num_classes: int = 1000, seed: int = 0) -> Iterator[dict]:
    """Endless synthetic latent batches (for benchmarking and smoke tests)."""
    rs = np.random.RandomState(seed)
    while True:
        yield {
            "x": rs.randn(batch_size, channels, latent_size, latent_size).astype(np.float32),
            "y": rs.randint(0, num_classes, size=batch_size).astype(np.int32),
        }
