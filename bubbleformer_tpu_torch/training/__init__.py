"""Training: forecast modules, optimizers, checkpoints and the loop."""
from bubbleformer_tpu_torch.training.checkpoint import (
    load_checkpoint,
    next_preempt_ckpt_path,
    restore_checkpoint,
    save_checkpoint,
)
from bubbleformer_tpu_torch.training.module import (
    ConditionedForecastModule,
    ForecastModule,
    module_class,
    resolve_device,
)
from bubbleformer_tpu_torch.training.optim import Lion, make_optimizer
from bubbleformer_tpu_torch.training.trainer import CSVLogger, Trainer

__all__ = [
    "load_checkpoint",
    "next_preempt_ckpt_path",
    "restore_checkpoint",
    "save_checkpoint",
    "ConditionedForecastModule",
    "ForecastModule",
    "module_class",
    "resolve_device",
    "Lion",
    "make_optimizer",
    "CSVLogger",
    "Trainer",
]
