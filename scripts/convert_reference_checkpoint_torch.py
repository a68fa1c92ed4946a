#!/usr/bin/env python3
"""Convert a reference Lightning ``.ckpt`` into a checkpoint of the PyTorch port.

Counterpart of ``scripts/convert_reference_checkpoint.py`` with the same
flags.  The reference's model zoo (Lightning checkpoints with a
``model.``-prefixed state dict, the normalization constants in
``hyper_parameters``) already uses the port's parameter names, so the
weights are loaded as they are, strictly: a missing or unexpected key
raises and names itself.  The model config is read off the weights
(``utils/convert.py:reference_model_cfg``: AViT or FiLMAViT, widths, heads,
fields, ``bias_type``) with ``--patch-size`` and ``--blocks``; the output is
the format ``scripts/train_torch.py`` writes (``training/checkpoint.py``),
with the constants and the step inside and a fresh optimizer state of
``--optim-cfg``, so ``scripts/inference_torch.py --ckpt`` reads it and
``scripts/train_torch.py checkpoint_path=...`` resumes from it under that
optimizer:

    python scripts/convert_reference_checkpoint_torch.py \\
        --ckpt hpc_ckpt_3.ckpt --patch-size 16 --blocks 12 --out converted.pt
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from types import SimpleNamespace

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from bubbleformer_tpu_torch.config import load_config
from bubbleformer_tpu_torch.models import get_model
from bubbleformer_tpu_torch.training import make_optimizer, save_checkpoint
from bubbleformer_tpu_torch.utils.convert import load_reference_checkpoint, reference_model_cfg


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True, help="Lightning .ckpt path")
    ap.add_argument("--patch-size", type=int, default=16)
    ap.add_argument("--blocks", type=int, default=12)
    ap.add_argument("--out", required=True, help="output checkpoint file (.pt)")
    ap.add_argument("--optim-cfg", default="lion",
                    help="optimizer config group whose fresh state the checkpoint holds")
    args = ap.parse_args(argv)

    state_dict, norm, step = load_reference_checkpoint(args.ckpt)
    model_cfg = reference_model_cfg(state_dict, args.patch_size, args.blocks)
    model = get_model(model_cfg["name"], **model_cfg["params"])
    model.load_state_dict(state_dict, strict=True)
    # The optimizer as the training module builds it: the schedule sets lr.
    optim_cfg = load_config([f"optim_cfg={args.optim_cfg}"])["optim_cfg"]
    opt_params = {k: v for k, v in optim_cfg.get("params", {}).items()
                  if k not in ("lr", "use_triton")}
    optimizer = make_optimizer(optim_cfg["name"], model.parameters(), **opt_params)
    save_checkpoint(args.out, SimpleNamespace(step=step, model=model, optimizer=optimizer,
                                              normalization_constants=norm))
    n = sum(p.numel() for p in model.parameters())
    print(f"model config: {json.dumps(model_cfg)}")
    print(f"converted {n/1e6:.2f}M params -> {args.out}"
          + (" (with normalization constants)" if norm else ""))


if __name__ == "__main__":
    main()
