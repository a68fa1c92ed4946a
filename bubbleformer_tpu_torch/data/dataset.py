"""Sliding-window HDF5 dataset: the parts training and the rollout use.

A subset of ``bubbleformer_tpu/data/dataset.py:BubbleForecast`` — windowing,
normalization (constants computed on the training files and adopted by the
validation set, ``normalize(diff, div)``) and the fluid-parameter vector;
not the native C batch assembler — with the same indexing:
samples per file ``traj_len - start_time - 2*time_window + 1``, input window
``[start, start+tw)``, target ``[start+tw, start+2tw)``.  Samples are numpy
``(T, C, H, W)`` float32.  ``h5py`` is imported when a file is opened.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

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
    try:
        import h5py
    except ImportError as exc:
        raise ImportError("reading trajectory files needs h5py (pip install h5py)") from exc
    return h5py


def fluid_params_vector(params: Dict) -> np.ndarray:
    """The 9-vector of a trajectory's JSON sidecar, in FLUID_PARAM_KEYS order."""
    values = [params[k[0]][k[1]] if isinstance(k, tuple) else params[k] for k in FLUID_PARAM_KEYS]
    return np.asarray(values, dtype=np.float32)


def _streaming_field_stats(dset, chunk: int = 64) -> Dict[str, float]:
    """One-pass count/sum/sumsq/min/max over a ``(T, H, W)`` HDF5 dataset."""
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
    """Map-style dataset over HDF5 trajectory files."""

    def __init__(self, filenames: Sequence[str], input_fields: Optional[List[str]] = None,
                 output_fields: Optional[List[str]] = None, norm: str = "none",
                 downsample_factor: int = 1, time_window: int = 16, start_time: int = 50,
                 return_fluid_params: bool = False):
        h5 = _h5py()
        self.filenames = list(filenames)
        self.input_fields = list(input_fields) if input_fields else list(DEFAULT_FIELDS)
        self.output_fields = list(output_fields) if output_fields else list(DEFAULT_FIELDS)
        self.norm = norm
        self.downsample_factor = downsample_factor
        self.time_window = time_window
        self.start_time = start_time
        self.return_fluid_params = return_fluid_params

        self.data = [h5.File(fname, "r") for fname in self.filenames]
        self.traj_lens = [f[self.input_fields[0]].shape[0] for f in self.data]
        self.fields = list(dict.fromkeys(self.input_fields + self.output_fields))
        self.diff_terms: Dict[str, float] = {k: 0.0 for k in self.fields}
        self.div_terms: Dict[str, float] = {k: 1.0 for k in self.fields}
        if self.return_fluid_params:
            self.fluid_params = []
            for fname in self.filenames:
                with open(fname.replace(".hdf5", ".json"), "r", encoding="utf-8") as f:
                    self.fluid_params.append(json.load(f))

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

    def close(self) -> None:
        for f in self.data:
            f.close()
