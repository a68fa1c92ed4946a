"""Run configuration.

``FILM_AVIT_SMALL`` is ``model_cfg/film_avit_small.yaml`` — the default
model of ``config/default.yaml`` — as a dict, so the chip smoke test runs
without PyYAML (``tests/test_torch_model.py`` holds it equal to the file).
"""
from bubbleformer_tpu_torch.config.loader import DEFAULT_CONFIG_DIR, load_config

FILM_AVIT_SMALL = {
    "name": "filmavit",
    "params": {
        "patch_size": 16,
        "embed_dim": 384,
        "processor_blocks": 12,
        "num_heads": 6,
        "drop_path": 0.2,
        "attn_scale": True,
        "feat_scale": True,
        "num_fluid_params": 9,
    },
}

__all__ = ["DEFAULT_CONFIG_DIR", "FILM_AVIT_SMALL", "load_config"]
