"""npz point-cloud datasets and the threaded batch loader (a copy of
pointcloud_tpu/data/dataset.py:25-207; tests/test_torch_data.py holds the
code equal to the original, docstrings aside).

The on-disk contract is generate_pc's: one `.npz` per frame with `points`
(N, 3) plus feature arrays (`rgb`, `segmentation`), a `boundingbox`, and
object-array `ground_truth` / `classes` pairs. The datasets yield raw numpy
clouds; the train step applies the model's transforms on the device, so the
host loop only reads files and batches them. `BatchLoader` shuffles with
`np.random.default_rng(seed)` over the indices, as the JAX package does, so
both packages see the same batches in the same order.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np


def obs_to_pc(obs, features: Sequence[str]) -> np.ndarray:
    """Concatenate points with feature columns (reference utils.py:326-328)."""
    cols = [np.asarray(obs["points"], dtype=np.float32)]
    for f in features:
        arr = np.asarray(obs[f], dtype=np.float32)
        if arr.ndim == 1:
            arr = arr[:, None]
        cols.append(arr)
    return np.concatenate(cols, axis=1)


class PointCloudDataset:
    """Cloud -> cloud pairs for autoencoder training (utils.py:330-381).

    in_features/out_features: feature column names appended to xyz.
    Transforms are NOT applied here: the train step applies the model's
    transforms on the device (the `in_transform`/`out_transform` arguments
    exist for API parity and host-side use via transforms.apply_np).
    """

    def __init__(
        self,
        root_dir: str,
        files: Sequence[str] | None = None,
        in_features: Sequence[str] = ("rgb",),
        out_features: Sequence[str] = ("rgb",),
        in_transform=None,
        out_transform=None,
    ):
        self.root_dir = root_dir
        names = files if files is not None else sorted(os.listdir(root_dir))
        self.files = [f for f in names if f.endswith(".npz")]
        self.in_features = list(in_features)
        self.out_features = list(out_features)
        self.in_transform = in_transform
        self.out_transform = out_transform

    def __len__(self):
        return len(self.files)

    def filename(self, idx):
        return self.files[idx]

    def get_file(self, idx):
        return np.load(os.path.join(self.root_dir, self.files[idx]), allow_pickle=True)

    def _apply(self, transform, pc):
        if transform is None:
            return pc
        from pointcloud_tpu_torch.transforms import apply_np

        return apply_np(transform, pc)[0]

    def __getitem__(self, idx):
        obs = self.get_file(idx)
        if self.in_features == self.out_features:
            pc = obs_to_pc(obs, self.in_features)
            in_pc = self._apply(self.in_transform, pc)
            out_pc = (
                in_pc
                if self.out_transform is self.in_transform
                else self._apply(self.out_transform, pc)
            )
        else:
            in_pc = self._apply(self.in_transform, obs_to_pc(obs, self.in_features))
            out_pc = self._apply(self.out_transform, obs_to_pc(obs, self.out_features))
        return in_pc, out_pc


class PointCloudGTDataset:
    """Cloud -> ground-truth-state pairs (utils.py:384-429)."""

    def __init__(
        self,
        root_dir: str,
        files: Sequence[str] | None = None,
        in_features: Sequence[str] = ("rgb",),
        in_transform=None,
        out_transform=None,
        swap_xy: bool = False,
    ):
        self.root_dir = root_dir
        names = files if files is not None else sorted(os.listdir(root_dir))
        self.files = [f for f in names if f.endswith(".npz")]
        self.in_features = list(in_features)
        self.in_transform = in_transform
        self.out_transform = out_transform
        self.swap_xy = swap_xy

    def __len__(self):
        return len(self.files)

    def filename(self, idx):
        return self.files[idx]

    def get_file(self, idx):
        return np.load(os.path.join(self.root_dir, self.files[idx]), allow_pickle=True)

    def __getitem__(self, idx):
        obs = self.get_file(idx)
        out_data = {
            s: np.asarray(v, dtype=np.float32) for (s, v) in obs["ground_truth"]
        }
        pc = obs_to_pc(obs, self.in_features)
        if self.in_transform is not None:
            from pointcloud_tpu_torch.transforms import apply_np

            pc = apply_np(self.in_transform, pc)[0]
        if self.out_transform is not None:
            out_data = self.out_transform(out_data)
        return (pc, out_data) if not self.swap_xy else (out_data, pc)


def _stack(samples):
    """Stack a list of per-sample pytrees (tuples/dicts/arrays) into batches."""
    first = samples[0]
    if isinstance(first, tuple):
        return tuple(_stack([s[i] for s in samples]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack([s[k] for s in samples]) for k in first}
    return np.stack(samples)


class BatchLoader:
    """Threaded, prefetching batch iterator over a map-style dataset.

    The reference's DataLoader (train.py:183-192): `threads` IO workers
    decode npz files concurrently; assembled batches are staged in a bounded
    queue so host IO overlaps device compute. Drops the last partial batch
    when `drop_last`.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        threads: int = 6,
        prefetch: int = 2,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.threads = threads
        self.prefetch = prefetch
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        n = len(self)
        for b in range(n):
            yield order[b * self.batch_size : (b + 1) * self.batch_size]

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def produce():
            try:
                with ThreadPoolExecutor(self.threads) as pool:
                    for idxs in self._batches():
                        samples = list(pool.map(self.dataset.__getitem__, idxs))
                        q.put(_stack(samples))
            finally:
                q.put(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
