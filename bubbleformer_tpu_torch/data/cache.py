"""Memory-mapped field caches: one flat ``.npy`` per trajectory file and field.

Counterpart of ``bubbleformer_tpu/data/cache.py``, with the same naming
(``<base>.<field>.npy`` beside the trajectory file, or under ``cache_dir``)
and the same writer (a unique temporary name per writer, then
``os.replace``, so concurrent writers never expose a partial cache).  Each
cache is a ``(T, H, W)`` float32 array that the OS page cache serves to the
sliding windows and that the native assembler (:mod:`.native`) reads in
place.

Where every cache of a file exists, :func:`open_field_caches` needs neither
the ``.hdf5`` nor ``h5py``: a machine without ``h5py`` trains from caches
alone.  ``h5py`` is imported only to build a cache from an ``.hdf5``.
"""
from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Optional, Sequence

import numpy as np


def cache_path(h5_path: str, field: str, cache_dir: Optional[str] = None) -> str:
    base = os.path.basename(h5_path).replace(".hdf5", "").replace(".h5", "")
    directory = cache_dir if cache_dir else os.path.dirname(os.path.abspath(h5_path))
    return os.path.join(directory, f"{base}.{field}.npy")


def _write_atomically(path: str, shape, fill) -> None:
    """``fill(out)`` into a fresh ``(shape)`` float32 ``.npy`` memmap under a
    unique temporary name, then rename it to ``path`` unless another writer
    got there first."""
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".", suffix=".tmp",
                               dir=os.path.dirname(path))
    os.close(fd)
    try:
        out = np.lib.format.open_memmap(tmp, mode="w+", dtype=np.float32, shape=tuple(shape))
        fill(out)
        out.flush()
        del out
        if os.path.exists(path):
            os.unlink(tmp)  # another writer finished first
        else:
            os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def write_field_cache(path: str, data: np.ndarray) -> str:
    """Write one ``(T, H, W)`` field as a cache (numpy alone); returns the path."""
    data = np.asarray(data, dtype=np.float32)

    def fill(out):
        out[...] = data

    _write_atomically(path, data.shape, fill)
    return path


def ensure_field_cache(h5_path: str, field: str, cache_dir: Optional[str] = None,
                       chunk: int = 64) -> str:
    """The cache of one field, converted from the ``.hdf5`` (streaming, in
    chunks of ``chunk`` frames) unless it exists; returns its path."""
    path = cache_path(h5_path, field, cache_dir)
    if os.path.exists(path):
        return path
    try:
        import h5py
    except ImportError as exc:
        raise ImportError(
            f"{path} does not exist, and building it from {h5_path} needs h5py; write the "
            f"caches with numpy alone instead (scripts/make_sample_data_torch.py --format npy)"
        ) from exc
    with h5py.File(h5_path, "r") as f:
        dset = f[field]

        def fill(out):
            for t0 in range(0, dset.shape[0], chunk):
                out[t0 : t0 + chunk] = dset[t0 : t0 + chunk]

        _write_atomically(path, dset.shape, fill)
    return path


def open_field_caches(filenames: Sequence[str], fields: Sequence[str],
                      cache_dir: Optional[str] = None) -> List[Dict[str, np.ndarray]]:
    """Per file, a dict of memory-mapped ``(T, H, W)`` float32 field arrays."""
    return [{field: np.load(ensure_field_cache(fname, field, cache_dir), mmap_mode="r")
             for field in fields} for fname in filenames]


def have_field_caches(filename: str, fields: Sequence[str]) -> bool:
    """Whether every field of ``filename`` has its cache beside it."""
    return all(os.path.exists(cache_path(filename, f)) for f in fields)
