"""Host input pipeline: seeded shuffling, batching, background prefetch.

Counterpart of ``bubbleformer_tpu/data/pipeline.py``'s ``DataLoader`` on one
process: full batches only (``drop_last``), a per-epoch permutation from
``seed + epoch`` (``set_epoch``), samples read by a thread pool and batches
assembled one ahead of the consumer.  The native C batch assembler and the
per-process sharding of the JAX package are not ported.
:func:`synthetic_batch` makes the same random batches as the JAX package's
from the same seed, and :class:`SyntheticLoader` serves them where no data
files are at hand.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np


class DataLoader:
    """Iterable over batched numpy samples of a map-style dataset."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 num_workers: int = 4, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle deterministically per epoch."""
        self._epoch = epoch

    def _indices(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        return order

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator:
        indices = self._indices()
        if self.drop_last:
            indices = indices[: len(self) * self.batch_size]
        batches = [indices[i : i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        q: queue.Queue = queue.Queue(maxsize=1)
        stop = threading.Event()
        errors = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce(pool):
            try:
                for idx in batches:
                    samples = list(pool.map(self.dataset.__getitem__, idx))
                    parts = range(len(samples[0]))
                    if not put(tuple(np.stack([s[k] for s in samples]) for k in parts)):
                        return
            except BaseException as exc:  # handed to the consumer below
                errors.append(exc)
            finally:
                put(None)

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            thread = threading.Thread(target=produce, args=(pool,), daemon=True)
            thread.start()
            try:
                while (item := q.get()) is not None:
                    yield item
                if errors:
                    raise errors[0]
            finally:
                stop.set()
                thread.join()


def synthetic_batch(batch_size: int, time_window: int, channels: int, height: int, width: int,
                    num_fluid_params: Optional[int] = None, seed: int = 0):
    """Random (inp, tgt[, fluid_params]) batch for benchmarks and tests."""
    rng = np.random.default_rng(seed)
    shape = (batch_size, time_window, channels, height, width)
    inp = rng.standard_normal(shape, dtype=np.float32)
    tgt = rng.standard_normal(shape, dtype=np.float32)
    if num_fluid_params is None:
        return inp, tgt
    cond = rng.standard_normal((batch_size, num_fluid_params), dtype=np.float32)
    return inp, tgt, cond


class SyntheticLoader:
    """``num_batches`` synthetic batches of ``size`` x ``width`` frames
    (``width`` defaults to ``size``), batch ``i`` drawn from seed ``seed +
    i`` once, when the loader is made (set-up, not step time), and served
    again every epoch."""

    def __init__(self, num_batches: int, batch_size: int, time_window: int, channels: int,
                 size: int, num_fluid_params: Optional[int] = None, seed: int = 0,
                 width: Optional[int] = None):
        self.batches = [synthetic_batch(batch_size, time_window, channels, size, width or size,
                                        num_fluid_params, seed=seed + i)
                        for i in range(num_batches)]

    def set_epoch(self, epoch: int) -> None:
        pass

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)
