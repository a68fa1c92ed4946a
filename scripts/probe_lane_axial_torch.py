#!/usr/bin/env python3
"""``scripts/probe_lane_axial.py`` on the PyTorch port's CUDA kernels.

The same flags as the JAX probe, plus ``--device`` (default ``cuda``; without
a card it raises unless ``--device cpu`` is given, where the kernels' plain
versions run and no device time is taken).  See
``bubbleformer_tpu_torch/probes/lane_axial.py``.

    python3 scripts/probe_lane_axial_torch.py
    python3 scripts/probe_lane_axial_torch.py --device cpu
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bubbleformer_tpu_torch.probes.lane_axial import main  # noqa: E402

if __name__ == "__main__":
    main()
