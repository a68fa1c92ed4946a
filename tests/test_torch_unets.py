"""The port's U-Nets against the JAX package's on the CPU: each block of
``layers/convs.py``, ModernUnet (hidden 8, ``ch_mults`` (1, 2)) and
ClassicUnet (hidden 4) forward in float32 and bfloat16, every parameter
gradient of the training criterion, ClassicUnet's running statistics after a
train-mode step, three Lion steps through the training modules, and the
weight bridge's round trip.

Inputs come from a numpy seed; weights are the JAX model's, drawn at O(1)
(norm scales around 1, biases and running means at 0.1, running variances in
[0.5, 1.5]) and carried to the port by ``unet_params_to_state_dict``.  Frames
are 32 x 32 at batch 2, so ClassicUnet's bottleneck holds B*H*W = 8 pixels,
where the biased and the unbiased batch variance differ by 14%.  No input
puts a norm's one-pass variance (flax's) in cancellation: every mean is of
the order of its spread.

Tolerances: float32 forwards 1e-5 of max|ref| (the same formulas summed in
other orders); bfloat16 2e-2 (the same rounding points, one bfloat16 ulp
apart where the two libraries' convolutions round differently); gradients
1e-4 of each gradient's largest magnitude, or of a hundredth of the largest
of all where a gradient is zero up to rounding (a conv bias whose output
enters a GroupNorm group of one channel); running statistics 1e-6 in float32
(2e-2 after a bfloat16 window).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bubbleformer_tpu.layers import convs as jax_convs
from bubbleformer_tpu.models import get_model as jax_get_model
from bubbleformer_tpu.training import ForecastModule as JaxForecastModule
from bubbleformer_tpu.utils.losses import LpLoss as JaxLpLoss
from bubbleformer_tpu_torch.layers import convs
from bubbleformer_tpu_torch.models import get_model
from bubbleformer_tpu_torch.training import ForecastModule
from bubbleformer_tpu_torch.utils.convert import unet_params_to_state_dict
from bubbleformer_tpu_torch.utils.losses import LpLoss

MODELS = {"unet_modern": {"hidden_channels": 8, "ch_mults": [1, 2], "norm": True},
          "unet_classic": {"hidden_channels": 4}}
DATA_CFG = {"input_fields": ["dfun", "temperature", "velx", "vely"],
            "output_fields": ["dfun", "temperature", "velx", "vely"], "time_window": 5}
SHAPE = (2, 5, 4, 32, 32)
CRITERION = dict(d=2, p=2, reduce_dims=[0, 1, 2], reductions=["mean", "mean", "sum"])
LION = {"name": "lion", "params": {"lr": 1e-3, "weight_decay": 0.1}}
SCHED = {"name": "cosine_warmup", "params": {"warmup_iters": 2, "eta_min": 1e-6}}
DTYPES = {"float32": (None, torch.float32, 1e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def randomize(variables, seed):
    """Every leaf at O(1): kernels lecun-normal, norm scales 1 + 0.1 N,
    biases 0.1 N; running means 0.1 N and variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return jnp.asarray(rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32))
        a = rng.standard_normal(leaf.shape)
        if "kernel" in name:
            a = a / np.sqrt(np.prod(leaf.shape[:-1]))
        elif "scale" in name:
            a = 1.0 + 0.1 * a
        else:
            a = 0.1 * a
        return jnp.asarray(a.astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, dict(variables))


def data(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def check_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, (what, err)


def check_running_stats(model, batch_stats, tol):
    """The port's running statistics against flax's ``batch_stats``."""
    sd = unet_params_to_state_dict({}, batch_stats)
    own = model.state_dict()
    assert sd and set(sd) <= set(own)
    for k, v in sd.items():
        np.testing.assert_allclose(own[k].numpy(), v.numpy(), rtol=0, atol=tol, err_msg=k)


def check_grads(got, want, tol):
    """Each gradient within ``tol`` of its own largest magnitude, or of a
    hundredth of the largest of all where it is zero up to rounding."""
    floor = 1e-2 * max(np.abs(w.numpy()).max() for w in want.values())
    assert set(got) == set(want)
    for k, w in want.items():
        w = w.numpy().astype(np.float64)
        err = np.abs(got[k].numpy() - w).max() / max(np.abs(w).max(), floor)
        assert err <= tol, (k, err)


BLOCKS = {
    "residual": (lambda dt: jax_convs.ResidualBlock(8, 16, dtype=dt),
                 lambda dt: convs.ResidualBlock(8, 16, dtype=dt), 8),
    "residual_same_width": (lambda dt: jax_convs.ResidualBlock(16, 16, dtype=dt),
                            lambda dt: convs.ResidualBlock(16, 16, dtype=dt), 16),
    "residual_no_norm": (lambda dt: jax_convs.ResidualBlock(8, 16, norm=False, dtype=dt),
                         lambda dt: convs.ResidualBlock(8, 16, norm=False, dtype=dt), 8),
    "middle": (lambda dt: jax_convs.MiddleBlock(16, dtype=dt),
               lambda dt: convs.MiddleBlock(16, dtype=dt), 16),
    "classic": (lambda dt: jax_convs.ClassicUnetBlock(16, dtype=dt),
                lambda dt: convs.ClassicUnetBlock(8, 16, dtype=dt), 8),
    "upsample": (lambda dt: jax_convs.Upsample(8, dtype=dt),
                 lambda dt: convs.Upsample(8, dtype=dt), 8),
    "downsample": (lambda dt: jax_convs.Downsample(8, dtype=dt),
                   lambda dt: convs.Downsample(8, dtype=dt), 8),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", BLOCKS)
def test_blocks_match_jax(name, dtype):
    """Each block of ``layers/convs.py`` on (2, 8, 8, C) (ClassicUnetBlock in
    train mode, with its running statistics, and in eval mode); the output
    dtype is the JAX block's (a ResidualBlock's bfloat16, a ClassicUnetBlock's
    float32)."""
    jax_dt, torch_dt, tol = DTYPES[dtype]
    make_jax, make_port, cin = BLOCKS[name]
    x = data((2, 8, 8, cin), seed=1)
    block = make_jax(jax_dt)
    variables = randomize(block.init(jax.random.key(0), jnp.asarray(x)), 2)
    port = make_port(torch_dt if jax_dt is not None else None)
    port.load_state_dict(unet_params_to_state_dict(variables))
    modes = ((False, True) if name == "classic" else (False,))
    for train in modes:
        port.train(train)
        with torch.no_grad():
            got = port(nchw(x))
        if name == "classic":
            want, updates = block.apply(variables, jnp.asarray(x), train=train,
                                        mutable=["batch_stats"])
            if train:
                check_running_stats(port, updates["batch_stats"], 1e-6 if jax_dt is None else tol)
        else:
            want = block.apply(variables, jnp.asarray(x))
        assert got.dtype == {jnp.dtype(jnp.bfloat16): torch.bfloat16,
                             jnp.dtype(jnp.float32): torch.float32}[want.dtype]
        check_close(got.float().permute(0, 2, 3, 1), want.astype(jnp.float32), tol,
                    f"{name} train={train}")


def _jax_model(name, dtype=None):
    """The JAX model and randomized variables (drawn from the init's shapes)."""
    model = jax_get_model(name, **MODELS[name], input_fields=4, output_fields=4, time_window=5,
                          dtype=dtype)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros(SHAPE)))
    return model, randomize(shapes, 3)


def _port_model(name, variables, dtype=None):
    model = get_model(name, **MODELS[name], input_fields=4, output_fields=4, time_window=5,
                      dtype=dtype)
    model.load_state_dict(unet_params_to_state_dict(variables))
    return model


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,train", [("unet_modern", False), ("unet_classic", False),
                                        ("unet_classic", True)])
def test_models_match_jax(name, train, dtype):
    """Each model's window (ClassicUnet in eval and in train mode) from the
    same bridged weights; the output dtype is the JAX model's; the running
    statistics after the train-mode window."""
    jax_dt, torch_dt, tol = DTYPES[dtype]
    jax_model, variables = _jax_model(name, jax_dt)
    port = _port_model(name, variables, torch_dt if jax_dt is not None else None)
    x = data(SHAPE, seed=4)
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    def apply(v, a):
        return jax_model.apply(v, a, train=train, mutable=["batch_stats"] if train else False)

    # bfloat16 op by op: under jit, XLA's CPU fusions skip some of the
    # model's bfloat16 roundings (ClassicUnet in train mode then reads 2.5%
    # from its op-by-op self, the port 0.55%).
    out = (jax.jit(apply) if jax_dt is None else apply)(variables, jnp.asarray(x))
    want = out[0] if train else out
    assert got.dtype == torch_dt and want.dtype == (jax_dt or jnp.float32)
    check_close(got.float(), want.astype(jnp.float32), tol, name)
    if train:
        # float32: 1e-6 (the bottleneck's statistics are over 8 pixels, where
        # the unbiased variance would be 14% off); bfloat16: the statistics of
        # activations one bfloat16 ulp apart, 2e-2.
        check_running_stats(port, out[1]["batch_stats"], 1e-6 if jax_dt is None else tol)


@pytest.mark.parametrize("name", MODELS)
def test_gradients_match_jax(name):
    """Every parameter gradient of the training criterion in float32, in
    train mode (ClassicUnet normalising with the batch's statistics)."""
    jax_model, variables = _jax_model(name)
    x, tgt = data(SHAPE, seed=5), data(SHAPE, seed=6)
    rest = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(p):
        pred, _ = jax_model.apply({"params": p, **rest}, jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
        return JaxLpLoss(**CRITERION)(pred, jnp.asarray(tgt))

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    port = _port_model(name, variables).train()
    loss = LpLoss(**CRITERION)(port(torch.from_numpy(x)), torch.from_numpy(tgt))
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    got = {k: p.grad for k, p in port.named_parameters()}
    check_grads(got, unet_params_to_state_dict({"params": grads}), 1e-4)


def record_lion_ties(module, tol=1e-4):
    """Wrap ``module.optimizer.step`` to mark, before each update, the
    elements whose Lion argument ``b1 m + (1 - b1) g`` lies within ``tol`` of
    its tensor's largest magnitude (or of a hundredth of the largest of all):
    there the sign is rounding noise.  Returns the marks by parameter name."""
    opt, names = module.optimizer, dict(module.model.named_parameters())
    ties = {n: torch.zeros_like(p, dtype=torch.bool) for n, p in names.items()}
    step = opt.step

    def marked_step():
        b1 = opt.param_groups[0]["betas"][0]
        args = {n: (b1 * opt.state[p]["exp_avg"] if opt.state[p] else 0.0) + (1 - b1) * p.grad
                for n, p in names.items()}
        floor = 1e-2 * max(a.abs().max().item() for a in args.values())
        for n, a in args.items():
            ties[n] |= a.abs() <= tol * max(a.abs().max().item(), floor)
        return step()

    opt.step = marked_step
    return ties


@pytest.mark.parametrize("name", MODELS)
def test_three_lion_steps_match_jax(name):
    """Three Lion steps (lr 1e-3, a 2-step cosine warmup) of the port's
    ``ForecastModule`` against the JAX module's ``make_train_step`` from the
    same weights on the same batches: losses 1e-5 relative; parameters and
    running statistics within 1e-4.  Lion moves each element by lr times a
    sign, so a sign that differs shows as 2 lr (2e-3 at the last step) and
    fails, except where Lion's argument is zero up to rounding (a gradient
    within 1e-4 of its tensor's scale, as the gradient test holds it; and
    ModernUnet's conv1 biases before a GroupNorm group of one channel, zero
    as a whole): there each side's sign is its rounding noise, and such an
    element is held to the steps' whole units of lr."""
    model_cfg = {"name": name, "params": MODELS[name]}
    batches = [tuple(data(SHAPE, seed=10 + 2 * i + j) for j in range(2)) for i in range(3)]
    ref = JaxForecastModule(model_cfg, DATA_CFG, LION, SCHED, total_steps=10)
    _, variables = _jax_model(name)
    state = ref.init_state(jax.random.key(0), batches[0]).replace(
        params=variables["params"], batch_stats=variables.get("batch_stats"),
        opt_state=ref.optimizer.init(variables["params"]))
    step = jax.jit(ref.make_train_step())
    want_losses, lrs = [], []
    for b in batches:
        state, m = step(state, tuple(jnp.asarray(a) for a in b), jax.random.key(1))
        want_losses.append(float(m["loss"]))
        lrs.append(float(m["learning_rate"]))

    port = ForecastModule(model_cfg, DATA_CFG, LION, SCHED, total_steps=10, device="cpu")
    port.model.load_state_dict(unet_params_to_state_dict(variables))
    start = {k: v.clone() for k, v in port.model.state_dict().items()}
    ties = record_lion_ties(port)
    got = [port.train_step(tuple(torch.from_numpy(a) for a in b)) for b in batches]
    np.testing.assert_allclose([float(m["loss"]) for m in got], want_losses, rtol=1e-5)
    np.testing.assert_allclose([m["learning_rate"] for m in got], lrs, rtol=1e-6)
    assert lrs[0] == 0.0 and port.step == 3

    want = unet_params_to_state_dict(jax.tree.map(np.asarray, {
        "params": state.params, **({"batch_stats": state.batch_stats}
                                   if state.batch_stats is not None else {})}))
    own = port.model.state_dict()
    assert set(want) == set(own)
    tied = 0
    for k, w in want.items():
        err = (own[k] - w).abs()
        tie = ties.get(k, torch.zeros_like(err, dtype=torch.bool))
        assert (err[~tie] <= 1e-4).all(), k
        assert (err[tie] <= 2 * sum(lrs) + 1e-4).all(), k
        assert not torch.equal(own[k], start[k]), k  # every parameter and statistic moved
        tied += int(tie.sum())
    assert tied < 1e-2 * sum(w.numel() for w in want.values())  # ties are few


def state_dict_to_variables(state_dict):
    """The bridge's inverse, written here as the round trip's reference: a
    U-Net state_dict -> flax variables ``{"params", "batch_stats"}``.  Conv
    ``(O, I, kh, kw)`` and ConvTranspose ``(I, O, kh, kw)`` weights both go
    back by the axes ``(2, 3, 1, 0)``; 1-D weights are norm scales."""
    variables = {"params": {}}
    for key, value in state_dict.items():
        path, leaf = key.rsplit(".", 1)
        a = value.numpy()
        coll = "batch_stats" if leaf.startswith("running_") else "params"
        leaf = {"running_mean": "mean", "running_var": "var"}.get(leaf, leaf)
        if leaf == "weight":
            leaf, a = ("kernel", a.transpose(2, 3, 1, 0)) if a.ndim == 4 else ("scale", a)
        node = variables.setdefault(coll, {})
        for name in path.split("."):
            node = node.setdefault(name, {})
        node[leaf] = a
    return variables


@pytest.mark.parametrize("name,params", [("unet_modern", MODELS["unet_modern"]),
                                         ("unet_modern", {"hidden_channels": 8,
                                                          "ch_mults": [1, 2, 2, 4, 4]}),
                                         ("unet_classic", MODELS["unet_classic"])])
def test_bridge_round_trip_is_exact(name, params):
    """JAX variables -> state_dict -> JAX variables, leaf by leaf, bit for
    bit; the state_dict's keys and shapes are the port model's own (at the
    five levels of the full-width config too, at hidden 8)."""
    jax_model = jax_get_model(name, **params, input_fields=4, output_fields=4, time_window=5)
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.key(0), jnp.zeros(SHAPE)))
    # Distinct values in every leaf, so any misplaced element shows.
    variables = jax.tree.map(lambda s: np.arange(np.prod(s.shape), dtype=np.float32)
                             .reshape(s.shape), dict(shapes))
    sd = unet_params_to_state_dict(variables)
    with torch.device("meta"):
        port = get_model(name, **params, input_fields=4, output_fields=4, time_window=5)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in port.state_dict().items()}
    back = state_dict_to_variables(sd)
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert sorted(jax.tree_util.keystr(k) for k, _ in got) == sorted(
        jax.tree_util.keystr(k) for k, _ in want)
    got = {jax.tree_util.keystr(k): v for k, v in got}
    for k, v in want:
        np.testing.assert_array_equal(got[jax.tree_util.keystr(k)], v,
                                      err_msg=jax.tree_util.keystr(k))
