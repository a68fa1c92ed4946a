from bubbleformer_tpu_torch.models._api import (
    MODELS,
    build_model,
    get_model,
    list_models,
    register_model,
)
from bubbleformer_tpu_torch.models.axial_vit import AViT, FiLMAViT, SpaceTimeBlock
from bubbleformer_tpu_torch.models.unets import ClassicUnet, ModernUnet

__all__ = [
    "MODELS",
    "build_model",
    "get_model",
    "list_models",
    "register_model",
    "AViT",
    "FiLMAViT",
    "SpaceTimeBlock",
    "ClassicUnet",
    "ModernUnet",
]
