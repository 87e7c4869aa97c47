"""Batched host loader with weighted sampling and background prefetch.

Counterpart of ``mdhs_tpu/data/loader.py``: batches are dicts of stacked
numpy arrays of static shape (uint8 canvases; the preprocessing happens on
the device). For eval the order is sequential and a tail batch is padded by
repeating its first record, with ``n_valid`` marking the real rows; for
training the order is shuffled, or drawn with class-balanced weights, from
``np.random.default_rng(seed)``, as in JAX. A background thread makes the
next batches while the device works on the current one.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


def class_balanced_weights(labels, num_classes: int) -> np.ndarray:
    """Per-sample weights total / (num_classes * count)."""
    counts = np.zeros(num_classes, np.float64)
    for label in labels:
        if 0 <= label < num_classes:
            counts[label] += 1
    total = max(1, len(labels))
    per_class = np.where(counts > 0, total / (num_classes * np.maximum(counts, 1)), 0.0)
    return np.asarray([per_class[label] if 0 <= label < num_classes else 0.0 for label in labels])


def _stack(records: list[dict]) -> dict:
    out = {}
    for key in records[0]:
        vals = [r[key] for r in records]
        out[key] = vals if key == "image_id" else np.stack(vals)
    return out


class DataLoader:
    """Iterates epoch batches: shuffle or weighted sampling for training;
    sequential with tail padding (and ``n_valid``) for eval."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, weighted: bool = False,
                 num_classes: int = 0, seed: int = 0, drop_last: bool = False, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.weighted = weighted
        self.num_classes = num_classes
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.weighted:
            w = class_balanced_weights(self.dataset.labels, self.num_classes)
            return self._rng.choice(n, size=n, replace=True, p=w / w.sum())
        idx = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[dict]:
        idx = self._indices()
        n = len(idx)
        bs = self.batch_size

        def gen():
            for start in range(0, n, bs):
                chunk = idx[start:start + bs]
                if len(chunk) < bs:
                    if self.drop_last:
                        return
                    # pad by repeating the first record; n_valid marks the real rows
                    pad = np.concatenate([chunk, np.repeat(chunk[:1], bs - len(chunk))])
                    batch = _stack([self.dataset[i] for i in pad])
                    batch["n_valid"] = np.int32(len(chunk))
                else:
                    batch = _stack([self.dataset[i] for i in chunk])
                    batch["n_valid"] = np.int32(bs)
                yield batch

        if self.prefetch <= 0:
            yield from gen()
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = object()
        stop = threading.Event()

        def put(item) -> bool:
            # give up when the consumer left the epoch (break or exception), so the
            # worker does not block on a full queue forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            # a dataset failure surfaces in the consumer instead of ending the epoch early
            try:
                for b in gen():
                    if not put(b):
                        return
                put(done)
            except BaseException as exc:  # noqa: BLE001 - re-raised in the consumer
                put(exc)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is done:
                    break
                if isinstance(b, BaseException):
                    raise b
                yield b
        finally:
            stop.set()
            t.join(timeout=5.0)
