"""Reference Lightning checkpoints in the port: ``utils/convert.py:
load_reference_checkpoint`` and ``scripts/convert_reference_checkpoint_torch.py``
against the JAX package's ``convert_avit_state_dict`` on the same file.

Each ``.ckpt`` is built here as the reference's Lightning writes one: the
model's state dict under ``model.``, the normalization constants in
``hyper_parameters`` (an ``AttributeDict``, which torch's weights-only
unpickler refuses, as a Lightning file's hyper-parameters may be), and
``global_step``; the weights are drawn from a seed at O(1) (LayerScale gammas
and attn scales near 1), so no block is near identity.  Outputs are held to
1e-5 of their largest magnitude (float32, another summation order).
"""
import importlib.util
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.models import get_model as jax_get_model
from bubbleformer_tpu.utils.convert import convert_avit_state_dict
from bubbleformer_tpu_torch.models import get_model
from bubbleformer_tpu_torch.training import load_checkpoint
from bubbleformer_tpu_torch.utils.convert import load_reference_checkpoint, reference_model_cfg

REPO = Path(__file__).resolve().parents[1]


def _script(name):
    """``scripts/{name}.py`` as a module, its ``main`` callable with argv."""
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


converter = _script("convert_reference_checkpoint_torch")

SMALL = dict(patch_size=4, embed_dim=16, num_heads=2, processor_blocks=2, input_fields=4,
             output_fields=4, time_window=2)
NORM = ({"dfun": 0.25, "temperature": 0.5, "velx": -0.125, "vely": 0.0},
        {"dfun": 1.5, "temperature": 2.0, "velx": 0.75, "vely": 1.25})


class AttributeDict(dict):
    """Lightning's dict of hyper-parameters (``lightning.fabric.utilities.
    data.AttributeDict``), which a checkpoint pickles by its class."""


def seeded_weights(model, seed):
    """O(1) weights for every tensor of ``model``, from ``seed``; the FiLM
    projection near identity (gamma ~1, beta ~0), as
    ``tests/test_torch_model.py:randomize`` draws it and for its reason."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("film_embed.film_net.1"):
            c = p.shape[0] // 2
            a = 0.1 * rng.standard_normal(p.shape) / (3.0 if leaf == "weight" else 1.0)
            a = a if leaf == "weight" else a + np.concatenate([np.ones(c), np.zeros(c)])
        elif leaf.startswith(("gamma", "attn_scale")):
            a = rng.uniform(0.5, 1.5, p.shape)
        elif p.ndim >= 2:
            a = rng.standard_normal(p.shape) / np.sqrt(np.prod(p.shape[1:]))
        else:
            a = (1.0 if leaf == "weight" else 0.0) + 0.2 * rng.standard_normal(p.shape)
        out[name] = torch.from_numpy(a.astype(np.float32))
    return out


def write_ckpt(path, model, hyper=True, step=7, seed=0):
    """A Lightning-style checkpoint of ``model`` with weights from ``seed``;
    returns the weights."""
    weights = seeded_weights(model, seed)
    data = {"state_dict": {f"model.{k}": v for k, v in weights.items()}, "global_step": step,
            "epoch": 1}
    if hyper:
        data["hyper_parameters"] = AttributeDict(normalization_constants=NORM, lr=1e-4)
    torch.save(data, path)
    return weights


@pytest.mark.parametrize("film", [True, False], ids=["filmavit", "avit"])
@pytest.mark.parametrize("bias_type", ["rel", "continuous"])
def test_reference_ckpt_matches_jax_conversion(tmp_path, bias_type, film):
    name = "filmavit" if film else "avit"
    extra = {"num_fluid_params": 9} if film else {}
    path = tmp_path / "ref.ckpt"
    weights = write_ckpt(path, get_model(name, **SMALL, **extra, bias_type=bias_type))
    with pytest.raises(pickle.UnpicklingError):
        torch.load(path, weights_only=True)

    sd, norm, step = load_reference_checkpoint(str(path))
    assert norm == NORM and step == 7
    cfg = reference_model_cfg(sd, patch_size=4, blocks=2)
    assert cfg["name"] == name and cfg["params"]["bias_type"] == bias_type
    port = get_model(cfg["name"], **cfg["params"]).eval()
    port.load_state_dict(sd, strict=True)
    assert all(torch.equal(port.state_dict()[k], v) for k, v in weights.items())

    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 2, 4, 16, 16)).astype(np.float32)
    cond = rng.standard_normal((1, 9)).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x), *((torch.from_numpy(cond),) if film else ())).numpy()

    raw = torch.load(path, weights_only=False)["state_dict"]
    params = convert_avit_state_dict(raw, patch_size=4, processor_blocks=2,
                                     strip_prefix="model.")
    ref = jax_get_model(name, **SMALL, **extra, bias_type=bias_type, attn_impl="plain")
    want = np.asarray(jax.jit(ref.apply)({"params": params}, jnp.asarray(x),
                                         *((jnp.asarray(cond),) if film else ())))
    assert np.abs(want - x).max() > 0.5
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


def test_ckpt_without_hyper_parameters_has_no_constants(tmp_path):
    path = tmp_path / "bare.ckpt"
    write_ckpt(path, get_model("avit", **SMALL), hyper=False, step=0)
    sd, norm, step = load_reference_checkpoint(str(path))
    assert norm is None and step == 0
    assert not any(k.startswith("model.") for k in sd)


@pytest.mark.parametrize("change", ["missing", "unexpected"])
def test_converter_names_a_wrong_key(tmp_path, change):
    path = tmp_path / "bad.ckpt"
    write_ckpt(path, get_model("avit", **SMALL, bias_type="continuous"))
    data = torch.load(path, weights_only=False)
    key = "blocks.1.spatial.rel_pos_bias.cpb_mlp.2.weight"
    if change == "missing":
        del data["state_dict"][f"model.{key}"]
    else:
        key = "blocks.1.spatial.rel_pos_bias.extra"
        data["state_dict"][f"model.{key}"] = torch.zeros(2)
    torch.save(data, path)
    with pytest.raises(RuntimeError, match=key.replace(".", r"\.")):
        converter.main(["--ckpt", str(path), "--patch-size", "4", "--blocks", "2",
                        "--out", str(tmp_path / "out.pt")])
    assert not (tmp_path / "out.pt").exists()


def test_converted_checkpoint_rolls_out(tmp_path, capsys):
    """The converter's output (film_avit_tiny's widths, continuous bias) is
    a checkpoint of the port's format with the constants inside, and
    ``scripts/inference_torch.py --device cpu`` rolls it out on a
    ``make_sample_data.py`` trajectory."""
    _script("make_sample_data").main(["--out", str(tmp_path), "--n", "1", "--frames", "24",
                                      "--size", "64"])
    tiny = dict(patch_size=8, embed_dim=96, num_heads=6, processor_blocks=4, input_fields=4,
                output_fields=4, num_fluid_params=9, bias_type="continuous")
    ckpt, out = tmp_path / "zoo.ckpt", tmp_path / "zoo.pt"
    weights = write_ckpt(ckpt, get_model("filmavit", **tiny), step=11, seed=3)
    capsys.readouterr()
    converter.main(["--ckpt", str(ckpt), "--patch-size", "8", "--blocks", "4",
                    "--out", str(out)])
    assert "with normalization constants" in capsys.readouterr().out.splitlines()[-1]
    saved = load_checkpoint(str(out))
    assert saved["step"] == 11 and tuple(saved["norm_constants"]) == NORM
    assert all(torch.equal(saved["model"][k], v) for k, v in weights.items())

    _script("inference_torch").main([
        "--ckpt", str(out), "--data", str(tmp_path / "sample_1.hdf5"), "--model-cfg",
        "film_avit_tiny", "--data-cfg", "singlebubble", "--steps", "10", "--start-time", "5",
        "--save-dir", str(tmp_path / "roll"), "--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("window ")]
    assert len(lines) == 2 and all(np.isfinite(float(ln.split()[-1])) for ln in lines)
    preds = np.load(tmp_path / "roll" / "predictions.npz")["preds"]
    assert preds.shape == (10, 4, 64, 64) and np.isfinite(preds).all()
