"""The measurement probes of ``scripts/probe_*.py``, on the port's kernels.

Each module is the counterpart of one JAX probe and holds its Pallas
kernels' CUDA counterparts (``csrc/probe_*.cu``), each with its plain
PyTorch version and a launch counter, the probe's input builder
(``make_inputs``, the JAX probe's draws) and its ``main``, which the thin
CLIs ``scripts/probe_*_torch.py`` run:

- :mod:`.lane_axial` — P1, ``probe_lane_axial.py``: ``within_roll``,
  ``lane_core``;
- :mod:`.chunk_axial` — P2, ``probe_chunk_axial.py``: ``dot_combos``,
  ``perm_product``, ``chunk_core``;
- :mod:`.pyramid` — P3, ``probe_pyramid_pallas.py``: ``stage``;
- :mod:`.mosaic` — P4, ``probe_mosaic.py``: ``gram``, ``view_copy``,
  ``chunk_gram_apply`` under the 14 probe bodies.

A wrapper takes its plain version for CPU tensors, launches its kernel for
CUDA tensors (counting the launch) and raises on any other device.
"""
from __future__ import annotations

import re
import subprocess
import sys
import time
from collections import defaultdict

import torch


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def check_device(what: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (take
    the plain version); raises for any other device."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {t.device}")


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the card, as
    ``--query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def build_seconds(dev: torch.device):
    """Seconds to build (or load) the kernel library on a card; None on the
    CPU, where nothing is built."""
    if dev.type != "cuda":
        return None
    from bubbleformer_tpu_torch import _build

    t0 = time.perf_counter()
    _build.library()
    return time.perf_counter() - t0


def cuda_ms(fn, steps: int, dev: torch.device, warmup: int = 3):
    """Milliseconds per call of ``fn`` by CUDA events over ``steps`` calls
    after ``warmup``; None on the CPU (no device time to take)."""
    if dev.type != "cuda":
        return None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / steps


def launch_ms(fn, calls: int = 5) -> dict:
    """Device milliseconds of each kernel launch in one call of ``fn``, by
    ``torch.profiler`` over ``calls`` calls after one untraced call.  Names
    lose ``void``, the port's namespaces and the argument list, and keep 70
    characters; a kernel launched more than once a call gets its place
    among them ([0] first).  Where the launches do not split evenly into
    ``calls`` calls, each name holds its time over all of them / ``calls``."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evts = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    names = [re.sub(r"\(.*", "", re.sub(r"^void |bft::|\(anonymous namespace\)::", "",
                                        e.name))[:70] for e in evts]
    even = len(evts) % calls == 0
    one = names[:len(names) // calls] if even else names
    per = defaultdict(float)
    for i, (name, evt) in enumerate(zip(names, evts)):
        if even and one.count(name) > 1:
            name = f"{name} [{one[:i % len(one)].count(name)}]"
        per[name] += evt.time_range.elapsed_us() / 1e3 / calls
    return dict(per)


def announce(dev: torch.device) -> None:
    """The probes' first lines: the backend on stderr and, on a card, its
    ``nvidia-smi`` name and power limit on stdout."""
    if dev.type == "cuda":
        log("backend:", "cuda", torch.cuda.get_device_name(dev))
        print(card_name(), flush=True)
    else:
        log("backend:", dev.type)
