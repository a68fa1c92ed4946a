#!/usr/bin/env python3
"""Host input-pipeline throughput of the PyTorch port at training scale.

Counterpart of ``scripts/probe_loader.py``: writes ``--trajs`` BubbleML-shaped
trajectories of ``--frames`` frames at ``--size``^2 as ``.npy`` field caches
(``scripts/make_sample_data_torch.py --format npy``: numpy alone, no h5py),
then times the port's ``DataLoader`` end to end (shuffled, ``--workers``
threads, std normalization, windows of 5) over ``--batches`` batches after 3
warm-up batches, on the numpy path and on the native path (the C/OpenMP
assembler over the memory-mapped caches).  Prints ms/batch and samples/s of
each, then one JSON line (also written to ``--out`` where given).  The
caches are read warm: the writer leaves them in the page cache.

    python scripts/probe_loader_torch.py
    python scripts/probe_loader_torch.py --batch 2 --size 64 --frames 20 --batches 4
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

FIELDS = ["dfun", "temperature", "velx", "vely"]


def time_loader(loader, batches: int, warmup: int = 3) -> float:
    """Seconds per batch over ``batches`` batches after ``warmup``, starting
    a new epoch whenever one runs out."""
    epoch = 0

    def batches_forever():
        nonlocal epoch
        while True:
            loader.set_epoch(epoch)
            yield from loader
            epoch += 1

    it = batches_forever()
    for _ in range(warmup):
        next(it)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    seconds = (time.perf_counter() - t0) / batches
    it.close()
    return seconds


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--trajs", type=int, default=2)
    ap.add_argument("--batches", type=int, default=40)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from bubbleformer_tpu_torch.data import BubbleForecast, DataLoader, native
    from scripts.make_sample_data_torch import main as make_samples

    workdir = args.workdir or tempfile.mkdtemp(prefix="loader_probe_")
    make_samples(["--out", workdir, "--n", str(args.trajs), "--frames", str(args.frames),
                  "--size", str(args.size), "--format", "npy"])
    ds = BubbleForecast([os.path.join(workdir, f"sample_{i + 1}.hdf5") for i in range(args.trajs)],
                        input_fields=FIELDS, output_fields=FIELDS, norm="std", time_window=5,
                        start_time=0)
    ds.normalize()

    results = {}
    for path in ("numpy", "native"):
        if path == "native" and not ds.enable_native():
            results["native"] = {"unavailable": native.unavailable_reason()}
            print(f"native loader unavailable: {native.unavailable_reason()}", flush=True)
            continue
        loader = DataLoader(ds, batch_size=args.batch, shuffle=True, seed=0,
                            num_workers=args.workers)
        dt = time_loader(loader, args.batches)
        results[path] = {"ms_per_batch": dt * 1e3, "samples_per_s": args.batch / dt}
        print(f"{path}: {dt * 1e3:.2f} ms/batch ({args.batch / dt:.2f} samples/s host)",
              flush=True)
    out = {"batch": args.batch, "size": args.size, "workers": args.workers,
           "batches": args.batches, "cpus": os.cpu_count(), **results}
    print(json.dumps(out))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
