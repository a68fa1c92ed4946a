"""The port's data path against the JAX package's: the native C batch
assembler, the ``.npy`` field caches, caches-only datasets (no h5py), the
native ``DataLoader``, ``scripts/train_torch.py``'s ``native_loader`` and
``mesh_cfg``, the physics gate's metrics and the 500-step rollout tool.

Trajectories come from ``scripts/make_sample_data.py`` (HDF5, the JAX side)
and ``scripts/make_sample_data_torch.py`` (the port's writer) in
``tmp_path``.  Tolerances: the data path is exact (``==``, bit for bit),
except against the JAX native assembler, which multiplies by ``1 / div``
where the numpy path (and the port's assembler) divides: within one ulp,
and equal at ``norm="none"``; the gate's metrics are float32 reductions in
another order (relative 1e-5; the heat flux float64, 1e-9; vapor fractions
are counts, exact); the rollout curves 1e-4 of their largest magnitude over
three windows of 4 blocks, as ``tests/test_torch_rollout.py``.
"""
import contextlib
import importlib
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.config import load_config as jax_load_config
from bubbleformer_tpu.data import BubbleForecast as JaxForecast
from bubbleformer_tpu.data import DataLoader as JaxLoader
from bubbleformer_tpu.data import native as jax_native
from bubbleformer_tpu.data.cache import ensure_field_cache as jax_ensure_field_cache
from bubbleformer_tpu.inference import make_rollout_metrics_fn as jax_make_metrics_fn
from bubbleformer_tpu.models import get_model as jax_get_model
from bubbleformer_tpu.utils.heatflux import heatflux_series as jax_heatflux_series
from bubbleformer_tpu.utils import metrics as jax_metrics
from bubbleformer_tpu.utils.losses import LpLoss as JaxLpLoss
from bubbleformer_tpu_torch.config import load_config
from bubbleformer_tpu_torch.data import BubbleForecast, DataLoader, native
from bubbleformer_tpu_torch.data.cache import cache_path
from bubbleformer_tpu_torch.models import build_model
from bubbleformer_tpu_torch.utils.convert import jax_params_to_state_dict

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from scripts import inference_torch, physics_gate_torch, record_rollout_500_torch  # noqa: E402
from scripts import make_sample_data, make_sample_data_torch, train_torch  # noqa: E402

FIELDS = ["dfun", "temperature", "velx", "vely"]
NORMS = ["none", "std", "minmax", "tanh"]
FRAMES, SIZE = 30, 16


def _write(script, out, *args):
    script.main(["--out", str(out), "--n", "2", *map(str, args)])
    return [str(out / f"sample_{i}.hdf5") for i in (1, 2)]


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    return _write(make_sample_data, tmp_path_factory.mktemp("h5"), "--frames", FRAMES,
                  "--size", SIZE)


@pytest.fixture(scope="module")
def npy_files(tmp_path_factory):
    return _write(make_sample_data_torch, tmp_path_factory.mktemp("npy"), "--frames", FRAMES,
                  "--size", SIZE, "--format", "npy")


@contextlib.contextmanager
def hidden_h5py():
    """``import h5py`` fails inside; the JAX package, which imports it at
    the top, keeps it outside."""
    saved = sys.modules.get("h5py")
    sys.modules["h5py"] = None
    try:
        yield
    finally:
        if saved is None:
            del sys.modules["h5py"]
        else:
            sys.modules["h5py"] = saved


@pytest.fixture
def no_h5py():
    with hidden_h5py():
        yield


def _kw(norm, factor=1, **extra):
    return dict(input_fields=FIELDS, output_fields=FIELDS[:2], norm=norm,
                downsample_factor=factor, time_window=3, start_time=4, **extra)


@pytest.mark.parametrize("factor", [1, 2])
@pytest.mark.parametrize("norm", NORMS)
def test_native_batches_match_jax(jax_files, npy_files, norm, factor):
    """(a) The port's assembler (caches alone) against the JAX numpy path
    (bit for bit) and the JAX native assembler (one ulp; equal at none)."""
    assert native.available() and jax_native.available()
    ref = JaxForecast(jax_files, **_kw(norm, factor, return_fluid_params=True))
    with hidden_h5py():
        port = BubbleForecast(npy_files, **_kw(norm, factor, return_fluid_params=True))
    assert port.normalize() == ref.normalize()
    idx = [0, 5, len(ref) // 2, len(ref) // 2 - 1, len(ref) - 1, 3]
    want = ref.get_batch(idx)
    assert port.enable_native() and ref.enable_native()
    got, jax_nat = port.get_batch(idx), ref.get_batch(idx)
    for g, w, j in zip(got, want, jax_nat):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        if norm == "none":
            np.testing.assert_array_equal(g, j)
        else:
            np.testing.assert_array_max_ulp(g, j, maxulp=1)
    ref.close()


def test_field_stats_match_jax(npy_files):
    data = np.load(cache_path(npy_files[0], "temperature"))
    got, want = native.field_stats(data), jax_native.field_stats(data)
    assert got["min"] == want["min"] and got["max"] == want["max"]
    np.testing.assert_allclose([got["mean"], got["std"]], [want["mean"], want["std"]],
                               rtol=1e-12)


def test_native_library_builds_beside_the_kernels():
    """The assembler's library lives in the kernels' build directory under a
    hash of its source and flags (``_build.py``'s rule), not in a tempdir."""
    from bubbleformer_tpu_torch import _build

    assert native.available() and native.unavailable_reason() is None
    assert native.BUILD_DIR == _build.BUILD_DIR
    path = native.library_path()
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert path.name.startswith("libbatch_assembler_") and path.suffix == ".so"


def test_native_assembler_refuses_windows_outside_the_trajectory(npy_files):
    arr = np.load(cache_path(npy_files[0], "dfun"), mmap_mode="r")
    with pytest.raises(ValueError, match="outside a trajectory"):
        native.assemble_windows([arr], np.array([FRAMES - 2]), 3, 1, np.zeros(1), np.ones(1))


@pytest.mark.parametrize("fmt", ["npy", "hdf5"])
def test_sample_writer_matches_jax(jax_files, tmp_path, fmt):
    """(b) The port's writer: caches equal JAX's ensure_field_cache output
    byte for byte under the same names; HDF5 equal to the JAX script's."""
    import h5py

    port = _write(make_sample_data_torch, tmp_path, "--frames", FRAMES, "--size", SIZE,
                  "--format", fmt)
    (tmp_path / "jax_caches").mkdir()
    for mine, ref in zip(port, jax_files):
        with open(mine.replace(".hdf5", ".json")) as a, open(ref.replace(".hdf5", ".json")) as b:
            assert json.load(a) == json.load(b)
        for field in FIELDS:
            if fmt == "npy":
                want = jax_ensure_field_cache(ref, field, cache_dir=str(tmp_path / "jax_caches"))
                got = cache_path(mine, field)
                assert os.path.basename(got) == os.path.basename(want)
                assert Path(got).read_bytes() == Path(want).read_bytes()
            else:
                with h5py.File(mine) as a, h5py.File(ref) as b:
                    assert a[field].dtype == b[field].dtype
                    np.testing.assert_array_equal(a[field][...], b[field][...])
    if fmt == "npy":
        assert not any(Path(p).exists() for p in port)  # no .hdf5 written


@pytest.mark.parametrize("norm,factor", [("none", 1), ("std", 1), ("minmax", 2), ("tanh", 1)])
def test_caches_only_dataset_matches_jax(jax_files, npy_files, norm, factor):
    """(c) Without h5py: constants (==), length, samples, fluid parameters."""
    with hidden_h5py():
        with pytest.raises(ImportError):
            importlib.import_module("h5py")
        port = BubbleForecast(npy_files, **_kw(norm, factor, return_fluid_params=True))
        assert all(isinstance(f, dict) for f in port.data)
        # The whole dataset's work, constants included, without h5py.
        constants = port.normalize()
        samples = [port[i] for i in (0, 9, len(port) // 2, len(port) - 1)]
    ref = JaxForecast(jax_files, **_kw(norm, factor, return_fluid_params=True))
    assert constants == ref.normalize()
    assert len(port) == len(ref) and port.traj_lens == ref.traj_lens
    for got, idx in zip(samples, (0, 9, len(ref) // 2, len(ref) - 1)):
        assert len(got) == 3
        for a, b in zip(got, ref[idx]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    ref.close()


@pytest.mark.parametrize("opened", ["caches", "hdf5"])
def test_enable_native_reuses_open_caches(jax_files, npy_files, tmp_path, opened):
    """A file opened from its caches keeps those memory maps on the native
    path; one opened through h5py gets its caches built under ``cache_dir``."""
    if opened == "caches":
        with hidden_h5py():
            port = BubbleForecast(npy_files, **_kw("std"))
    else:
        port = BubbleForecast(jax_files, **_kw("std"))
    port.normalize()
    want = port.get_batch([0, 7, len(port) - 1])
    assert port.enable_native(cache_dir=str(tmp_path))
    if opened == "caches":
        assert all(c is d for c, d in zip(port._native_caches, port.data))
        assert not list(tmp_path.iterdir())
    else:
        assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
            f"sample_{i}.{f}.npy" for i in (1, 2) for f in FIELDS)
    for g, w in zip(port.get_batch([0, 7, len(port) - 1]), want):
        np.testing.assert_array_equal(g, w)
    port.close()


@pytest.mark.parametrize("threads", [1, 2, 5])
def test_assembler_team_size_leaves_batches_unchanged(npy_files, threads):
    """The OpenMP team's size changes who writes each frame, never a value."""
    fields = [np.load(cache_path(npy_files[0], f), mmap_mode="r") for f in FIELDS]
    starts, diff, div = np.array([0, 9, 4]), np.full(4, 0.25), np.full(4, 3.0)
    want = native.assemble_windows(fields, starts, 3, 2, diff, div)
    got = native.assemble_windows(fields, starts, 3, 2, diff, div, threads=threads)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("path,batch", [("native", 4), ("native", 16), ("numpy", 4)])
def test_loader_batches_through_get_batch(npy_files, monkeypatch, path, batch):
    """Both paths batch through ``get_batch``: the numpy one reads samples on
    the loader's pool, the native one sizes each call's OpenMP team so that
    the batches in flight share the CPUs (one thread each at least), with
    fewer in flight where the epoch has fewer batches than the window."""
    port = BubbleForecast(npy_files, **_kw("std"))
    port.normalize()
    if path == "native":
        assert port.enable_native()
    seen, real = [], port.get_batch
    monkeypatch.setattr(port, "get_batch",
                        lambda idx, **kw: seen.append(kw) or real(idx, **kw))
    teams, assemble = [], native.assemble_windows
    monkeypatch.setattr(native, "assemble_windows",
                        lambda *a, **k: teams.append(k["threads"]) or assemble(*a, **k))
    loader = DataLoader(port, batch, shuffle=True, seed=3, num_workers=3, prefetch=2)
    batches = list(loader)
    loader_teams = list(teams)  # the loader's calls alone
    assert len(batches) == len(seen) == len(port) // batch
    want_batches = [real(idx) for idx in
                    np.split(np.random.default_rng(3).permutation(len(port))[:len(seen) * batch],
                             len(seen))]
    for got, want in zip(batches, want_batches):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    if path == "native":
        team = max(1, len(os.sched_getaffinity(0)) // min(3, len(batches)))
        assert loader_teams and set(loader_teams) == {team}
        assert all(kw == {"threads": team} for kw in seen)
    else:
        assert not loader_teams and all(kw["pool"] is not None for kw in seen)


def test_dataset_without_files_or_caches_names_both(tmp_path, no_h5py):
    with pytest.raises(FileNotFoundError, match="h5py does not import.*make_sample_data_torch"):
        BubbleForecast([str(tmp_path / "missing.hdf5")], **_kw("none"))


@pytest.mark.parametrize("norm", ["none", "std"])
def test_native_loader_matches_jax(jax_files, npy_files, norm):
    """(d) Shuffled, seeded, two epochs: the same batches in the same order
    as JAX's native loader (one ulp off where it multiplies by 1 / div) and
    bit for bit as JAX's numpy-path loader."""
    port = BubbleForecast(npy_files, **_kw(norm))
    ref_native, ref_numpy = JaxForecast(jax_files, **_kw(norm)), JaxForecast(jax_files, **_kw(norm))
    for d in (port, ref_native, ref_numpy):
        d.normalize()
    assert port.enable_native() and ref_native.enable_native()
    loaders = [DataLoader(port, 4, shuffle=True, seed=7, num_workers=3, prefetch=2)] + [
        JaxLoader(d, 4, shuffle=True, seed=7, num_workers=3) for d in (ref_native, ref_numpy)]
    for epoch in (0, 1):
        for loader in loaders:
            loader.set_epoch(epoch)
        got, nat, num = ([b for b in loader] for loader in loaders)
        assert len(got) == len(nat) == len(num) == len(port) // 4
        for g, n, m in zip(got, nat, num):
            for a, b, c in zip(g, n, m):
                np.testing.assert_array_equal(a, c)
                np.testing.assert_array_max_ulp(a, b, maxulp=0 if norm == "none" else 1)


def _train(tmp_path, monkeypatch, capsys, *overrides):
    samples = tmp_path / "samples"
    _write(make_sample_data_torch, samples, "--frames", 20, "--size", SIZE, "--format", "npy")
    monkeypatch.setenv("BUBBLEML_SAMPLES", str(samples))
    calls = []
    real = native.assemble_windows
    monkeypatch.setattr(native, "assemble_windows",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    train_torch.main(["device=cpu", "model_cfg=avit_tiny", "data_cfg=samples_smoke",
                      "batch_size=2", "limit_train_batches=1", "limit_val_batches=1",
                      f"log_dir={tmp_path / 'logs'}", *overrides])
    return capsys.readouterr().out, len(calls)


@pytest.mark.parametrize("case", ["native", "numpy", "no_compiler"])
def test_train_cli_honours_native_loader(tmp_path, monkeypatch, capsys, no_h5py, case):
    """(e) native_loader=true batches through the assembler and says so;
    false takes the numpy path; where no compiler builds the assembler the
    CLI says why and takes the numpy path.  mesh_cfg=single runs."""
    if case == "no_compiler":
        monkeypatch.setattr(native, "COMPILERS", ("no-such-cc",))
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
        native._load.cache_clear()
    flag = "false" if case == "numpy" else "true"
    try:
        out, calls = _train(tmp_path, monkeypatch, capsys, f"native_loader={flag}",
                            "mesh_cfg=single")
    finally:
        native._load.cache_clear()  # the real library again for later tests
    if case == "native":
        assert "native loader: enabled" in out and calls > 0
    elif case == "numpy":
        assert "native loader" not in out and calls == 0
    else:
        assert "native loader: unavailable (no C compiler built" in out and "no-such-cc" in out
        assert calls == 0
    assert (tmp_path / "logs" / "avit_samples_smoke_local" / "last.pt").exists()


@pytest.mark.parametrize("override", ["mesh_cfg=dp_tp", "mesh_cfg=dp_sp", "mesh_cfg.model=2"])
def test_mesh_cfg_other_than_single_raises(override):
    """The composed config carries the mesh group; in a world of one process
    the mesh the training CLI builds from it raises for a model axis
    (``dp_tp`` runs in a world that can hold it: two processes a data rank,
    ``tests/test_torch_tensor_parallel.py``) and for a spatial axis (not
    ported)."""
    with pytest.raises(ValueError, match="mesh_cfg"):
        train_torch.main(["device=cpu", override])
    assert load_config(["mesh_cfg=single"])["mesh_cfg"] == {"data": -1, "model": 1}


def test_physics_gate_metrics_match_jax(npy_files):
    """(f) gate_metrics against scripts/physics_gate.py:165-268's
    computation with the JAX package's functions, on the same arrays."""
    windows, tw = 3, 5
    ds = BubbleForecast(npy_files[1:], input_fields=FIELDS, output_fields=FIELDS, norm="std",
                        time_window=tw, start_time=2)
    ds.normalize()
    targets = np.stack([ds[k * tw][1] for k in range(windows)])  # (W, T, C, H, W)
    rng = np.random.default_rng(0)
    preds = (targets + 0.3 * rng.standard_normal(targets.shape)).astype(np.float32)
    untrained = rng.standard_normal(targets.shape).astype(np.float32)
    got = physics_gate_torch.gate_metrics(preds, untrained, targets, FIELDS, ds.diff_terms,
                                          ds.div_terms, heater_temp=92.0)

    lp = JaxLpLoss(d=2, p=2, reduce_dims=[0, 1], reductions=["mean", "mean"])
    rel = [float(lp(jnp.asarray(preds[i]), jnp.asarray(targets[i]))) for i in range(windows)]
    rel_u = [float(lp(jnp.asarray(untrained[i]), jnp.asarray(targets[i])))
             for i in range(windows)]
    flat_pred, flat_tgt = preds.reshape(-1, 4, SIZE, SIZE), targets.reshape(-1, 4, SIZE, SIZE)
    eik = np.asarray(jax_metrics.eikonal_residual_per_step(jnp.asarray(flat_pred[:, 0])))
    drift = float(jax_metrics.mass_conservation_drift(jnp.asarray(flat_pred[:, 0]),
                                                      jnp.asarray(flat_tgt[:, 0])))

    def denorm(a, f):
        return a * ds.div_terms[f] + ds.diff_terms[f]

    kw = dict(heater_temp=92.0, dx=16.0 / SIZE, x_min=-8.0)
    hf_pred = jax_heatflux_series(denorm(flat_pred[:, 0], "dfun"),
                                           denorm(flat_pred[:, 1], "temperature"), **kw)
    hf_sim = jax_heatflux_series(denorm(flat_tgt[:, 0], "dfun"),
                                          denorm(flat_tgt[:, 1], "temperature"), **kw)
    kl = jax_metrics.heatflux_kl_divergence(hf_sim, hf_pred)

    np.testing.assert_allclose(got["rollout_rel_l2_per_window"], rel, rtol=1e-5)
    np.testing.assert_allclose(got["rollout_rel_l2_untrained_per_window"], rel_u, rtol=1e-5)
    np.testing.assert_allclose(got["eikonal_residual_mean"], eik.mean(), rtol=1e-5)
    assert got["vapor_fraction_drift"] == pytest.approx(drift, abs=1e-7)
    for key, want in (("heatflux_pred_mean", np.mean(hf_pred)), ("heatflux_pred_max",
                      np.max(hf_pred)), ("heatflux_sim_mean", np.mean(hf_sim)),
                      ("heatflux_sim_max", np.max(hf_sim)), ("heatflux_kl_sim_vs_model", kl)):
        np.testing.assert_allclose(got[key], want, rtol=1e-9, err_msg=key)
    assert set(physics_gate_torch.METRIC_KEYS) <= set(got)
    assert got["tolerances"] == {
        "rollout_rel_l2_final_max": 1.0, "untrained_improvement_min": 0.9,
        "eikonal_residual_max": 60.0, "vapor_fraction_drift_max": 0.5,
        "heatflux_mean_ratio_band": 2.0, "heatflux_kl_max": 5.0}
    assert got["ok"] == (not got["failures"])


def test_rollout_500_curves_match_jax(npy_files, no_h5py):
    """(g) The 500-step tool's curves over three windows of AViT-tiny with
    bridged weights against the JAX metrics rollout's."""
    windows, tw = 3, 5
    cfg = jax_load_config(["model_cfg=avit_tiny"])["model_cfg"]
    ref = jax_get_model(cfg["name"], **cfg["params"], input_fields=4, output_fields=4,
                        time_window=tw)
    ds = BubbleForecast(npy_files[:1], input_fields=FIELDS, output_fields=FIELDS, norm="std",
                        time_window=tw, start_time=2)
    ds.normalize()
    x = ds[0][0][None]
    rng = np.random.default_rng(1)

    def draw(path, leaf):  # weights over the init's shapes (eval_shape: no eager init)
        name, a = jax.tree_util.keystr(path), rng.standard_normal(leaf.shape)
        if "gamma" in name:
            a = rng.uniform(0.2, 0.6, leaf.shape)
        elif "scale" in name and "freq" not in name:
            a = 1.0 + 0.2 * a
        elif "kernel" in name:
            a = a / np.sqrt(np.prod(leaf.shape[:-1]))
        elif "bias" in name and "embedding" not in name:
            a = 0.1 * a
        return jnp.asarray(a.astype(np.float32))

    variables = jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(ref.init, jax.random.key(0), jnp.asarray(x)))
    port = build_model(cfg, {"input_fields": FIELDS, "output_fields": FIELDS, "time_window": tw})
    port.load_state_dict(jax_params_to_state_dict(variables))
    got, seconds = record_rollout_500_torch.rollout_500(port.eval(), ds, windows,
                                                        torch.device("cpu"), 0, False)
    targets = np.concatenate([ds[k * tw][1] for k in range(windows)])
    tgt = targets.reshape(windows, 1, tw, *targets.shape[1:])
    want = record_rollout_500_torch.window_curves(jax_make_metrics_fn(ref, windows, dfun_index=0)(
        variables, jnp.asarray(x), jnp.asarray(tgt)))
    assert sorted(got) == sorted(want) == ["eikonal", "rel_l2", "vapor_drift"] and seconds > 0
    for key in ("rel_l2", "eikonal"):
        assert got[key].shape == (windows,)
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=1e-4 * np.abs(want[key]).max(), err_msg=key)
    np.testing.assert_allclose(got["vapor_drift"], want["vapor_drift"], atol=2 / SIZE**2)


def test_inference_cli_reads_caches_alone(npy_files, tmp_path, no_h5py, capsys):
    """``scripts/inference_torch.py --data`` from caches, no h5py."""
    cfg = {"input_fields": FIELDS, "output_fields": FIELDS, "time_window": 5}
    torch.manual_seed(0)
    torch.save(build_model(load_config(["model_cfg=avit_tiny"])["model_cfg"], cfg).state_dict(),
               tmp_path / "weights.pt")
    inference_torch.main(["--device", "cpu", "--ckpt", str(tmp_path / "weights.pt"),
                          "--data", npy_files[1], "--model-cfg", "avit_tiny", "--data-cfg",
                          "samples_smoke", "--steps", "10", "--start-time", "2",
                          "--save-dir", str(tmp_path / "roll")])
    out = capsys.readouterr().out
    assert "window 1: relative L2" in out
    saved = np.load(tmp_path / "roll" / "predictions.npz")
    assert saved["preds"].shape == (10, 4, SIZE, SIZE) and np.isfinite(saved["preds"]).all()
