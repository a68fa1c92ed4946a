from bubbleformer_tpu_torch.data.dataset import (
    FLUID_PARAM_KEYS,
    BubbleForecast,
    fluid_params_vector,
)
from bubbleformer_tpu_torch.data.pipeline import DataLoader, SyntheticLoader, synthetic_batch

__all__ = ["FLUID_PARAM_KEYS", "BubbleForecast", "fluid_params_vector", "DataLoader",
           "SyntheticLoader", "synthetic_batch"]
