"""The port's dataset subset, losses and metrics against the JAX package's,
on synthetic trajectories from ``scripts/make_sample_data.py``.

Dataset reads are exact (the same numpy arithmetic); losses and metrics are
float32 reductions summed in another order (1e-6 relative).
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.data import BubbleForecast as JaxForecast
from bubbleformer_tpu.inference import denormalize as jax_denormalize
from bubbleformer_tpu.inference import rollout_targets as jax_rollout_targets
from bubbleformer_tpu.utils import losses as jlosses
from bubbleformer_tpu.utils import metrics as jmetrics
from bubbleformer_tpu_torch.data import BubbleForecast
from bubbleformer_tpu_torch.inference import denormalize, rollout_targets
from bubbleformer_tpu_torch.utils import losses as tlosses
from bubbleformer_tpu_torch.utils import metrics as tmetrics

REPO = Path(__file__).resolve().parents[1]
FIELDS = ["dfun", "temperature", "velx", "vely"]


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    out = tmp_path_factory.mktemp("samples")
    subprocess.run(
        [sys.executable, str(REPO / "scripts" / "make_sample_data.py"), "--out", str(out),
         "--n", "2", "--frames", "30", "--size", "16"],
        check=True, capture_output=True, timeout=120,
    )
    return [str(out / "sample_1.hdf5"), str(out / "sample_2.hdf5")]


@pytest.mark.parametrize("norm", ["none", "std", "minmax", "tanh"])
def test_dataset_matches_jax(samples, norm):
    kw = dict(input_fields=FIELDS, output_fields=FIELDS[:2], norm=norm, time_window=5,
              start_time=3, return_fluid_params=True)
    ref, port = JaxForecast(samples, **kw), BubbleForecast(samples, **kw)
    assert port.normalize() == ref.normalize()
    assert len(port) == len(ref) and port.samples_per_file() == ref.samples_per_file()
    for idx in (0, 7, len(ref) - 1):
        for a, b in zip(port[idx], ref[idx]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    port.close()
    ref.close()


def test_rollout_targets_match_jax_and_stop_at_file_boundary(samples):
    kw = dict(input_fields=FIELDS, output_fields=FIELDS, time_window=5, start_time=3)
    ref, port = JaxForecast(samples, **kw), BubbleForecast(samples, **kw)
    for a, b in zip(rollout_targets(port, 2, 3), jax_rollout_targets(ref, 2, 3)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="crosses a trajectory-file boundary"):
        rollout_targets(port, 10, 3)  # 18 samples per file: index 20 is in file 2


def test_denormalize_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 4, 8, 8)).astype(np.float32)
    diff = dict(zip(FIELDS, [0.5, -1.0, 2.0, 0.0]))
    div = dict(zip(FIELDS, [2.0, 0.5, 1.5, 3.0]))
    np.testing.assert_allclose(
        denormalize(torch.from_numpy(x), FIELDS, diff, div).numpy(),
        np.asarray(jax_denormalize(jnp.asarray(x), FIELDS, diff, div)), rtol=1e-6,
    )


def test_losses_and_metrics_match_jax():
    rng = np.random.default_rng(1)
    pred = rng.standard_normal((10, 4, 16, 16)).astype(np.float32)
    tgt = rng.standard_normal((10, 4, 16, 16)).astype(np.float32)
    tp, tt = torch.from_numpy(pred), torch.from_numpy(tgt)
    jp, jt = jnp.asarray(pred), jnp.asarray(tgt)
    for kw in (dict(d=2, p=2, reduce_dims=[0, 1], reductions=["mean", "mean"]),
               dict(d=2, p=3, reduce_dims=0, reductions="sum")):
        np.testing.assert_allclose(tlosses.LpLoss(**kw)(tp, tt).numpy(),
                                   np.asarray(jlosses.LpLoss(**kw)(jp, jt)), rtol=1e-6)
    np.testing.assert_allclose(tmetrics.eikonal_residual_per_step(tp[:, 0]).numpy(),
                               np.asarray(jmetrics.eikonal_residual_per_step(jp[:, 0])),
                               rtol=1e-6)
    np.testing.assert_allclose(
        float(tmetrics.mass_conservation_drift(tp[:, 0], tt[:, 0])),
        float(jmetrics.mass_conservation_drift(jp[:, 0], jt[:, 0])), rtol=1e-6,
    )
    with pytest.raises(ValueError, match="reduction"):
        tlosses.LpLoss(reductions=["max"])


@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_matches_jax_loader(samples, shuffle):
    """Batches of the port's ``DataLoader`` — seeded per-epoch permutation,
    full batches only — equal the JAX package's on the same dataset, the
    validation set normalized with the training set's constants."""
    from bubbleformer_tpu.data import DataLoader as JaxLoader
    from bubbleformer_tpu_torch.data import DataLoader

    kw = dict(input_fields=FIELDS, output_fields=FIELDS, norm="std", time_window=3,
              start_time=2, return_fluid_params=True)
    train, jtrain = BubbleForecast(samples[:1], **kw), JaxForecast(samples[:1], **kw)
    consts = train.normalize()
    assert consts == jtrain.normalize()
    val, jval = BubbleForecast(samples[1:], **kw), JaxForecast(samples[1:], **kw)
    val.normalize(*consts)
    jval.normalize(*consts)
    loader = DataLoader(val, batch_size=4, shuffle=shuffle, seed=7, num_workers=2)
    jloader = JaxLoader(jval, batch_size=4, shuffle=shuffle, seed=7, num_workers=2)
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == len(loader) == len(val) // 4
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_synthetic_batches_match_jax():
    from bubbleformer_tpu.data import synthetic_batch as jax_synthetic_batch
    from bubbleformer_tpu_torch.data import SyntheticLoader, synthetic_batch

    for got, want in zip(synthetic_batch(2, 3, 4, 8, 8, 9, seed=5),
                         jax_synthetic_batch(2, 3, 4, 8, 8, 9, seed=5)):
        np.testing.assert_array_equal(got, want)
    loader = SyntheticLoader(2, 2, 3, 4, 8, seed=5)
    assert len(loader) == 2
    np.testing.assert_array_equal(list(loader)[1][0], synthetic_batch(2, 3, 4, 8, 8, seed=6)[0])
