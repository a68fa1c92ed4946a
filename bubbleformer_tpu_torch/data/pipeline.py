"""Host input pipeline: seeded shuffling, batching, background prefetch.

Counterpart of ``bubbleformer_tpu/data/pipeline.py``'s ``DataLoader``: full
batches only (``drop_last``), a per-epoch permutation from ``seed + epoch``
(``set_epoch``, the same on every process) and up to ``prefetch`` batches
queued ahead of the consumer.  In a world of processes each reads its own
``process_index``-strided shard of that permutation, truncated to ``n //
process_count`` samples so that every process runs the same number of steps
(``:57-69``).  Each batch is the dataset's ``get_batch``.  On the
numpy path a thread pool reads a batch's samples and the batches are
assembled one after another; on a native dataset
(``BubbleForecast.enable_native``) a batch is GIL-releasing C calls, and
several batches are in flight on the pool at once, each call's OpenMP team
a share of the CPUs, so that the batches in flight fill the machine once.
:func:`synthetic_batch` makes the same random batches as the JAX package's
from the same seed, and :class:`SyntheticLoader` serves them where no data
files are at hand, each process its rows of the global batch.
"""
from __future__ import annotations

import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np


class DataLoader:
    """Iterable over batches of a dataset with ``get_batch`` (``BubbleForecast``)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 num_workers: int = 4, prefetch: int = 4, drop_last: bool = True,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle deterministically per epoch (every process alike)."""
        self._epoch = epoch

    def _local_indices(self) -> np.ndarray:
        """This process's strided shard of the epoch's permutation, truncated
        to the common length: a process with one batch more would wait for
        the others in a collective that never comes."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        shard = order[self.process_index :: self.process_count]
        return shard[: n // self.process_count] if self.process_count > 1 else shard

    def __len__(self) -> int:
        n = len(self._local_indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _collate(self, pool, indices: np.ndarray, threads: int = 0):
        if getattr(self.dataset, "native", False):
            return self.dataset.get_batch(indices, threads=threads)
        return self.dataset.get_batch(indices, pool=pool)

    def __iter__(self) -> Iterator:
        indices = self._local_indices()
        if self.drop_last:
            indices = indices[: len(self) * self.batch_size]
        batches = [indices[i : i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
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
                if getattr(self.dataset, "native", False):
                    # A sliding window of futures: several native batches in
                    # flight, handed on in order.  The numpy path below stays
                    # serial: its _collate maps over the same pool, and
                    # submitting it from the pool's workers could deadlock.
                    # Each C call's OpenMP team is a share of the CPUs, so
                    # that the batches in flight fill the machine once.
                    inflight = max(1, min(self.num_workers, self.prefetch + 2, len(batches)))
                    threads = max(1, len(os.sched_getaffinity(0)) // inflight)
                    futures = deque(pool.submit(self._collate, pool, b, threads)
                                    for b in batches[:inflight])
                    for b in batches[inflight:] + [None] * len(futures):
                        item = futures.popleft().result()
                        if b is not None:
                            futures.append(pool.submit(self._collate, pool, b, threads))
                        if not put(item):
                            return
                    return
                for idx in batches:
                    if not put(self._collate(pool, idx)):
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
    again every epoch.  In a world of ``process_count`` processes batch ``i``
    is drawn at ``batch_size * process_count`` and each process keeps its
    own ``batch_size`` rows, in rank order, so that the world trains on what
    one process would at the global batch."""

    def __init__(self, num_batches: int, batch_size: int, time_window: int, channels: int,
                 size: int, num_fluid_params: Optional[int] = None, seed: int = 0,
                 width: Optional[int] = None, process_index: int = 0, process_count: int = 1):
        rows = slice(process_index * batch_size, (process_index + 1) * batch_size)
        self.batches = [tuple(a[rows] for a in synthetic_batch(
            batch_size * process_count, time_window, channels, size, width or size,
            num_fluid_params, seed=seed + i)) for i in range(num_batches)]

    def set_epoch(self, epoch: int) -> None:
        pass

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)
