from bubbleformer_tpu_torch.inference.rollout import (
    denormalize,
    make_rollout_fn,
    make_rollout_metrics_fn,
    rollout_targets,
    window_relative_l2,
)

__all__ = [
    "denormalize",
    "make_rollout_fn",
    "make_rollout_metrics_fn",
    "rollout_targets",
    "window_relative_l2",
]
