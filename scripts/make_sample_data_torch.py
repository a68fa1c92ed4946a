#!/usr/bin/env python3
"""Synthesize small BubbleML-shaped sample trajectories for the PyTorch port.

Counterpart of ``scripts/make_sample_data.py``, with the same generator
(:func:`bubble_trajectory`: an exact SDF bubble rising and wobbling, a
thermal plume and a velocity field around the bubble), seeds, file names and
fluid-parameter JSON sidecars, so both scripts write the same arrays from the
same seed bit for bit.  Two formats:

* ``--format hdf5`` (the default): ``sample_{i}.hdf5`` with the fields
  dfun/temperature/velx/vely as ``(T, H, W)`` float32, through h5py;
* ``--format npy``: the ``.npy`` field caches the port's dataset reads
  without h5py (``sample_{i}.{field}.npy``, named as
  ``bubbleformer_tpu_torch/data/cache.py:cache_path`` names the caches of
  ``sample_{i}.hdf5``), with numpy alone.

Data configs name the ``.hdf5`` paths either way
(``BUBBLEML_SAMPLES=out data_cfg=samples_smoke``).

    python scripts/make_sample_data_torch.py --out samples/ --n 2 --frames 50 --size 64
    python scripts/make_sample_data_torch.py --out samples/ --format npy --size 512 --frames 40
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from bubbleformer_tpu_torch.data.cache import cache_path, write_field_cache

FORMATS = ("hdf5", "npy")


def bubble_trajectory(frames: int, size: int, seed: int):
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(
        np.linspace(0, 1, size), np.linspace(0, 1, size), indexing="ij"
    )
    cx0, cy0 = rng.uniform(0.35, 0.65), rng.uniform(0.15, 0.3)
    radius = rng.uniform(0.08, 0.15)
    rise = rng.uniform(0.008, 0.012)
    wobble = rng.uniform(0.01, 0.03)

    dfun = np.empty((frames, size, size), np.float32)
    temp = np.empty_like(dfun)
    velx = np.empty_like(dfun)
    vely = np.empty_like(dfun)
    for t in range(frames):
        cx = cx0 + wobble * np.sin(0.3 * t)
        cy = cy0 + rise * t
        r = np.sqrt((xs - cx) ** 2 + (ys - cy) ** 2)
        dfun[t] = (radius - r).astype(np.float32)  # >0 inside bubble (vapor)
        temp[t] = (
            60.0
            + 30.0 * np.exp(-(((xs - cx) / 0.2) ** 2) - ((ys - 0.0) / 0.3) ** 2)
            + rng.normal(0, 0.2, (size, size))
        ).astype(np.float32)
        # Potential-flow-ish field around the bubble + buoyant updraft.
        theta = np.arctan2(ys - cy, xs - cx)
        speed = 0.1 * np.exp(-((r / (2 * radius)) ** 2))
        velx[t] = (speed * np.cos(theta) + rng.normal(0, 0.005, (size, size))).astype(
            np.float32
        )
        vely[t] = (
            speed * np.sin(theta)
            + 0.05 * np.exp(-(((xs - cx) / 0.25) ** 2))
            + rng.normal(0, 0.005, (size, size))
        ).astype(np.float32)
    return {"dfun": dfun, "temperature": temp, "velx": velx, "vely": vely}


def fluid_params(i: int) -> dict:
    """The JSON sidecar of trajectory ``i`` (0-based)."""
    return {
        "inv_reynolds": 0.0084,
        "cpgas": 0.83,
        "mugas": 1.0,
        "rhogas": 0.0083,
        "thcogas": 0.25,
        "stefan": 0.063,
        "prandtl": 8.34,
        "heater": {"nucWaitTime": 0.4, "wallTemp": 91.0 + i},
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="samples")
    ap.add_argument("--n", type=int, default=2)
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--format", choices=FORMATS, default="hdf5",
                    help="hdf5 through h5py, or npy: the field caches, numpy alone")
    args = ap.parse_args(argv)

    if args.format == "hdf5":
        try:
            import h5py
        except ImportError as exc:
            raise SystemExit(f"--format hdf5 needs h5py ({exc}); --format npy writes the "
                             "caches with numpy alone") from exc
    os.makedirs(args.out, exist_ok=True)
    for i in range(args.n):
        path = os.path.join(args.out, f"sample_{i + 1}.hdf5")
        fields = bubble_trajectory(args.frames, args.size, args.seed + i)
        if args.format == "hdf5":
            with h5py.File(path, "w") as f:
                for name, data in fields.items():
                    f.create_dataset(name, data=data)
            written = path
        else:
            for name, data in fields.items():
                write_field_cache(cache_path(path, name), data)
            written = cache_path(path, "{" + ",".join(fields) + "}")
        with open(path.replace(".hdf5", ".json"), "w") as f:
            json.dump(fluid_params(i), f, indent=2)
        print(f"wrote {written}")


if __name__ == "__main__":
    main()
