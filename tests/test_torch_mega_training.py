"""Three training steps on the ``mega`` route (K1 in the temporal branch,
K5 in the axial one) against the JAX package's train step through both
Pallas kernels in interpret mode, with the tolerances of
``tests/test_torch_training.py::test_three_train_steps_match_jax``."""
from tests.test_torch_training import TINY, _three_train_steps_match_jax


def test_three_train_steps_on_the_mega_route_match_jax():
    """Three AdamW steps of a tiny FiLMAViT on ``attn_impl="mega"`` (8x16
    tokens, 4 heads of 8): the forward and backward of K1's and K5's autograd
    Functions (their plain versions on the CPU) against the JAX
    ``ConditionedForecastModule`` train step through both Pallas kernels in
    interpret mode, with the tolerances of ``tests/test_torch_training.py::
    test_three_train_steps_match_jax``."""
    cfg = {"name": "filmavit", "params": dict(TINY["params"], embed_dim=32, attn_impl="mega")}
    port = _three_train_steps_match_jax(cfg, (32, 64))
    block = port.model.blocks[0]
    assert (block.temporal.attn_impl, block.spatial.attn_impl) == ("mega", "mega")
