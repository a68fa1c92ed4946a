"""The port's physics evaluation against the JAX package's: the heater heat
flux (numpy and on tensors), the per-field relative L2 and the KL divergence
of heat-flux distributions, on the inputs of ``tests/test_losses.py``'s
heat-flux tests (seeded numpy)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.utils.heatflux import heatflux as jax_pkg_heatflux
from bubbleformer_tpu.utils.heatflux import heatflux_jax
from bubbleformer_tpu.utils.heatflux import heatflux_series as jax_pkg_heatflux_series
from bubbleformer_tpu.utils.metrics import heatflux_kl_divergence as jax_pkg_kl
from bubbleformer_tpu.utils.metrics import relative_l2_per_field as jax_relative_l2
from bubbleformer_tpu_torch.utils.heatflux import heatflux, heatflux_series, heatflux_torch
from bubbleformer_tpu_torch.utils.metrics import heatflux_kl_divergence, relative_l2_per_field


def fields(seed=2, frames=3, size=512):
    rng = np.random.default_rng(seed)
    dfun = rng.standard_normal((frames, size, size)).astype(np.float32)
    temp = rng.uniform(50, 70, (frames, size, size)).astype(np.float32)
    return dfun, temp


@pytest.mark.parametrize("geometry", [{}, {"dx": 1.0 / 16.0, "x_min": -4.0}])
def test_heatflux_matches_jax(geometry):
    """The numpy pair and series against the JAX package's numpy ones, and
    ``heatflux_torch`` against ``heatflux_jax`` (both float32): rtol 1e-4;
    the default FC-72 512-grid geometry and another domain's."""
    dfun, temp = fields()
    np.testing.assert_allclose(heatflux_series(dfun, temp, 90, **geometry),
                               jax_pkg_heatflux_series(dfun, temp, 90, **geometry), rtol=1e-4)
    np.testing.assert_allclose(heatflux(dfun, temp, 90, **geometry),
                               jax_pkg_heatflux(dfun, temp, 90, **geometry), rtol=1e-4)
    want = heatflux_jax(jnp.asarray(dfun), jnp.asarray(temp), 90, **geometry)
    got = heatflux_torch(torch.from_numpy(dfun), torch.from_numpy(temp), 90, **geometry)
    np.testing.assert_allclose([t.item() for t in got], [float(w) for w in want], rtol=1e-4)
    assert got[0].item() > 0 and got[1].item() >= got[0].item()


def test_relative_l2_per_field_matches_jax():
    """(T, C, H, W) -> (T, C), 1e-6 relative."""
    rng = np.random.default_rng(3)
    preds, targets = (rng.standard_normal((6, 4, 64, 64)).astype(np.float32) for _ in range(2))
    want = np.asarray(jax_relative_l2(jnp.asarray(preds), jnp.asarray(targets)))
    got = relative_l2_per_field(torch.from_numpy(preds), torch.from_numpy(targets))
    assert got.shape == (6, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("shift", [0.0, 3.0])
def test_heatflux_kl_divergence_matches_jax(shift):
    """The same samples give the JAX package's value (1e-9 relative), with
    ``test_heatflux_kl_divergence_sanity``'s properties: near 0 for samples
    one noise apart, larger for shifted ones; constant samples raise."""
    rng = np.random.default_rng(4)
    a = rng.normal(0.0, 1.0, 500)
    b = a + rng.normal(0, 1e-3, 500) + shift
    got = heatflux_kl_divergence(a, b)
    assert got == pytest.approx(jax_pkg_kl(a, b), rel=1e-9)
    same = heatflux_kl_divergence(a, a + rng.normal(0, 1e-3, 500))
    assert same < 0.01
    if shift:
        assert got > same
    with pytest.raises(ValueError, match="constant"):
        heatflux_kl_divergence(np.ones(10), a)
