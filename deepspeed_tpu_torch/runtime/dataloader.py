"""Data loading (counterpart of ``deepspeed_tpu/runtime/dataloader.py``:
``DeepSpeedDataLoader`` + ``RepeatingLoader``).

Yields micro-batches collated into CPU tensors, in dataset order; the
engine moves them to its device.  Map-style datasets (indexable) and
iterables.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch


class DeepSpeedDataLoader:
    def __init__(self, dataset: Any, batch_size: int,
                 collate_fn: Optional[Callable] = None,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or default_collate
        self.drop_last = drop_last
        if hasattr(dataset, "__len__"):
            n = len(dataset)
            self.len = n // batch_size if drop_last else -(-n // batch_size)
        else:
            self.len = None

    def __len__(self) -> int:
        if self.len is None:
            raise TypeError("dataset has no length")
        return self.len

    def __iter__(self):
        if not hasattr(self.dataset, "__getitem__"):
            yield from _iter_batches(iter(self.dataset), self.batch_size,
                                     self.collate_fn, self.drop_last)
            return
        n = len(self.dataset)
        for start in range(0, n, self.batch_size):
            idx = range(start, min(n, start + self.batch_size))
            if len(idx) < self.batch_size and self.drop_last:
                return
            yield self.collate_fn([self.dataset[i] for i in idx])


class RepeatingLoader:
    """Wraps any loader into an infinite stream."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


def default_collate(samples: Sequence[Any]):
    """Stack samples into tensors, recursing through tuples, lists and
    dicts."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate(list(col))
                           for col in zip(*samples))
    if isinstance(first, torch.Tensor):
        return torch.stack(list(samples))
    return torch.from_numpy(np.stack([np.asarray(s) for s in samples]))


def _iter_batches(it, batch_size, collate_fn, drop_last):
    buf = []
    for sample in it:
        buf.append(sample)
        if len(buf) == batch_size:
            yield collate_fn(buf)
            buf = []
    if buf and not drop_last:
        yield collate_fn(buf)
