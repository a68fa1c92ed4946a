from bubbleformer_tpu_torch.data.dataset import (
    FLUID_PARAM_KEYS,
    BubbleForecast,
    fluid_params_vector,
)

__all__ = ["FLUID_PARAM_KEYS", "BubbleForecast", "fluid_params_vector"]
