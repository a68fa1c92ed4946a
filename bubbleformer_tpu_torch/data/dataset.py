"""Sliding-window dataset over BubbleML trajectories, with the native batch path.

Counterpart of ``bubbleformer_tpu/data/dataset.py:BubbleForecast`` —
windowing, normalization (constants computed on the training files and
adopted by the validation set, ``normalize(diff, div)``), the
fluid-parameter vector and the native C batch assembler
(``enable_native``, ``get_batch``) — with the same indexing: samples per
file ``traj_len - start_time - 2*time_window + 1``, input window
``[start, start+tw)``, target ``[start+tw, start+2tw)``.  Samples are numpy
``(T, C, H, W)`` float32.

Each file opens from its ``.hdf5`` where ``h5py`` imports and the file
exists, and otherwise from its ``.npy`` field caches
(:mod:`bubbleformer_tpu_torch.data.cache`): lengths from the caches' shapes,
fluid parameters from the ``.json`` sidecar, and the same streaming float64
statistics over the memory map, so a caches-only dataset's normalization
constants, samples and batches are those of the ``.hdf5`` bit for bit.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bubbleformer_tpu_torch.data.cache import have_field_caches, open_field_caches

DEFAULT_FIELDS = ["dfun", "temperature", "velx", "vely"]

# Fluid-parameter vector layout (bubbleformer_tpu/data/dataset.py:31-41).
FLUID_PARAM_KEYS = [
    "inv_reynolds",
    "cpgas",
    "mugas",
    "rhogas",
    "thcogas",
    "stefan",
    "prandtl",
    ("heater", "nucWaitTime"),
    ("heater", "wallTemp"),
]


def _h5py():
    """The ``h5py`` module, or None where it does not import."""
    try:
        import h5py
    except ImportError:
        return None
    return h5py


def fluid_params_vector(params: Dict) -> np.ndarray:
    """The 9-vector of a trajectory's JSON sidecar, in FLUID_PARAM_KEYS order."""
    values = [params[k[0]][k[1]] if isinstance(k, tuple) else params[k] for k in FLUID_PARAM_KEYS]
    return np.asarray(values, dtype=np.float32)


def _streaming_field_stats(dset, chunk: int = 64) -> Dict[str, float]:
    """One-pass count/sum/sumsq/min/max over a ``(T, H, W)`` HDF5 dataset or
    memory-mapped cache, in float64 chunks of ``chunk`` frames."""
    n, total, total_sq = 0, 0.0, 0.0
    vmin, vmax = np.inf, -np.inf
    for t0 in range(0, dset.shape[0], chunk):
        block = np.asarray(dset[t0 : t0 + chunk], dtype=np.float64)
        n += block.size
        total += float(block.sum())
        total_sq += float((block * block).sum())
        vmin = min(vmin, float(block.min()))
        vmax = max(vmax, float(block.max()))
    mean = total / n
    var = max(total_sq / n - mean * mean, 0.0)
    return {"mean": mean, "std": float(np.sqrt(var)), "min": vmin, "max": vmax}


class BubbleForecast:
    """Map-style dataset over trajectory files (``.hdf5``, or the ``.npy``
    caches beside them)."""

    def __init__(self, filenames: Sequence[str], input_fields: Optional[List[str]] = None,
                 output_fields: Optional[List[str]] = None, norm: str = "none",
                 downsample_factor: int = 1, time_window: int = 16, start_time: int = 50,
                 return_fluid_params: bool = False):
        self.filenames = list(filenames)
        self.input_fields = list(input_fields) if input_fields else list(DEFAULT_FIELDS)
        self.output_fields = list(output_fields) if output_fields else list(DEFAULT_FIELDS)
        self.norm = norm
        self.downsample_factor = downsample_factor
        self.time_window = time_window
        self.start_time = start_time
        self.return_fluid_params = return_fluid_params
        self.fields = list(dict.fromkeys(self.input_fields + self.output_fields))
        self.native = False  # get_batch through the C assembler (enable_native)

        # Per file, an open h5py.File or a dict of memory-mapped caches:
        # both map a field name to a (T, H, W) array-like.
        self.data = [self._open(fname) for fname in self.filenames]
        self.traj_lens = [f[self.input_fields[0]].shape[0] for f in self.data]
        self.diff_terms: Dict[str, float] = {k: 0.0 for k in self.fields}
        self.div_terms: Dict[str, float] = {k: 1.0 for k in self.fields}
        if self.return_fluid_params:
            self.fluid_params = []
            for fname in self.filenames:
                with open(fname.replace(".hdf5", ".json"), "r", encoding="utf-8") as f:
                    self.fluid_params.append(json.load(f))

    def _open(self, fname: str):
        h5 = _h5py()
        if h5 is not None and os.path.exists(fname):
            return h5.File(fname, "r")
        if have_field_caches(fname, self.fields):
            return open_field_caches([fname], self.fields)[0]
        why = ("h5py does not import" if h5 is None else f"{fname} does not exist")
        raise FileNotFoundError(
            f"cannot open {fname}: {why}, and its .npy field caches ({', '.join(self.fields)}) "
            f"are not all there (scripts/make_sample_data_torch.py --format npy writes them)")

    def samples_per_file(self) -> List[int]:
        return [n - self.start_time - 2 * self.time_window + 1 for n in self.traj_lens]

    def __len__(self) -> int:
        return sum(self.samples_per_file())

    def normalize(self, diff_terms: Optional[Dict[str, float]] = None,
                  div_terms: Optional[Dict[str, float]] = None
                  ) -> Tuple[Dict[str, float], Dict[str, float]]:
        """Compute (or adopt) per-field constants: per-file statistics
        averaged over files, ``+ 1e-8`` on the divisor."""
        if diff_terms is None and div_terms is None:
            diff_terms, div_terms = {}, {}
            for field in self.fields:
                diffs, divs = [], []
                for h5_file in self.data:
                    if self.norm == "none":
                        diffs.append(0.0)
                        divs.append(1.0)
                        continue
                    stats = _streaming_field_stats(h5_file[field])
                    if self.norm == "std":
                        diffs.append(stats["mean"])
                        divs.append(stats["std"])
                    elif self.norm == "minmax":
                        diffs.append(stats["min"])
                        divs.append(stats["max"] - stats["min"])
                    elif self.norm == "tanh":
                        diffs.append((stats["max"] + stats["min"]) / 2.0)
                        divs.append((stats["max"] - stats["min"]) / 2.0)
                    else:
                        raise ValueError(f"Unknown normalization type: {self.norm}")
                diff_terms[field] = float(np.mean(diffs))
                div_terms[field] = float(np.mean(divs)) + 1e-8
        self.diff_terms = diff_terms
        self.div_terms = div_terms
        return self.diff_terms, self.div_terms

    def _locate(self, idx: int) -> Tuple[int, int]:
        cumulative = np.cumsum(self.samples_per_file())
        file_idx = int(np.searchsorted(cumulative, idx, side="right"))
        offset = int(cumulative[file_idx - 1]) if file_idx > 0 else 0
        return file_idx, idx + self.start_time - offset

    def _read_window(self, file_idx: int, field: str, t0: int, t1: int) -> np.ndarray:
        data = np.asarray(self.data[file_idx][field][t0:t1], dtype=np.float32)
        f = self.downsample_factor
        if f > 1:
            data = data[:, ::f, ::f]
        return (data - self.diff_terms[field]) / self.div_terms[field]

    def __getitem__(self, idx: int):
        file_idx, start = self._locate(idx)
        tw = self.time_window
        inp = np.stack([self._read_window(file_idx, f, start, start + tw)
                        for f in self.input_fields])
        out = np.stack([self._read_window(file_idx, f, start + tw, start + 2 * tw)
                        for f in self.output_fields])
        inp = np.transpose(inp, (1, 0, 2, 3))  # (T, C, H, W)
        out = np.transpose(out, (1, 0, 2, 3))
        if self.return_fluid_params:
            return inp, out, fluid_params_vector(self.fluid_params[file_idx])
        return inp, out

    # -- native fast path -------------------------------------------------
    def enable_native(self, cache_dir: Optional[str] = None) -> bool:
        """Switch ``get_batch`` to the C/OpenMP assembler over memory-mapped
        caches.  A file opened from its caches keeps them; one opened through
        h5py gets its caches built once (beside it, or under ``cache_dir``)
        where missing.  Returns False, and stays on the numpy path, where the
        assembler is unavailable (``native.unavailable_reason()`` says why)."""
        from bubbleformer_tpu_torch.data import native

        if not native.available():
            return False
        self._native_caches = [
            opened if isinstance(opened, dict)
            else open_field_caches([fname], self.fields, cache_dir)[0]
            for fname, opened in zip(self.filenames, self.data)]
        self.native = True
        return True

    def get_batch(self, indices, pool=None, threads: int = 0):
        """A full ``(inp, tgt[, params])`` batch of the given indices: on the
        numpy path the samples (read through ``pool.map`` where a pool is
        given) stacked; on the native path one C call per sample and window
        by an OpenMP team of ``threads`` (0: every CPU), written straight
        into the batch; the same values bit for bit."""
        indices = np.asarray(indices, dtype=np.int64)
        if not self.native:
            samples = list(pool.map(self.__getitem__, indices) if pool is not None
                           else map(self.__getitem__, indices))
            return tuple(np.stack([s[j] for s in samples]) for j in range(len(samples[0])))

        from bubbleformer_tpu_torch.data import native

        tw, f = self.time_window, self.downsample_factor
        located = [self._locate(int(i)) for i in indices]
        h, w = self.data[0][self.input_fields[0]].shape[1:]
        inp = np.empty((len(indices), tw, len(self.input_fields), h // f, w // f), np.float32)
        out = np.empty((len(indices), tw, len(self.output_fields), h // f, w // f), np.float32)
        windows = [(inp, self.input_fields, 0), (out, self.output_fields, tw)]
        constants = [(np.asarray([self.diff_terms[k] for k in names]),
                      np.asarray([self.div_terms[k] for k in names])) for _, names, _ in windows]
        for row, (file_idx, start) in enumerate(located):
            caches = self._native_caches[file_idx]
            for (dst, names, shift), (diff, div) in zip(windows, constants):
                native.assemble_windows([caches[k] for k in names], np.asarray([start + shift]),
                                        tw, f, diff, div, out=dst[row : row + 1],
                                        threads=threads)
        if self.return_fluid_params:
            params = np.stack([fluid_params_vector(self.fluid_params[fi]) for fi, _ in located])
            return inp, out, params
        return inp, out

    def close(self) -> None:
        for f in self.data:
            if hasattr(f, "close"):
                f.close()
