"""The probes' kernels (P1-P3) against the JAX probes' Pallas kernels.

P1 (``scripts/probe_lane_axial.py``), P2 (``scripts/probe_chunk_axial.py``)
and P3 (``scripts/probe_pyramid_pallas.py``) on the CPU: each Pallas kernel
runs in interpret mode (built here from the probe's own body, or through the
probe with its ``pl`` swapped for one whose ``pallas_call`` interprets and
records), and the port's plain version (what its wrapper runs on the CPU)
gets the same inputs.  Tolerances, of the reference's largest magnitude:
float32 1e-5 (summation order only), bfloat16 2e-2 (single-ulp rounding
flips where reassociated float32 sums straddle a bf16 rounding edge, and
what they propagate into); the rolls and the 0/1 permutation product are
exact.  Each port input builder is held against the JAX probe's own draws,
read from its frame at small flags.  Last, the three probe CLIs run at
``--device cpu`` on tiny flags.
"""
import importlib.util
import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bubbleformer_tpu_torch.probes import chunk_axial, lane_axial, pyramid

REPO = Path(__file__).resolve().parents[1]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _load(name):
    """Import a JAX probe from scripts/ and restore the persistent-cache
    settings it changes at import."""
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])
    return mod


@pytest.fixture(scope="module")
def lane():
    return _load("probe_lane_axial")


@pytest.fixture(scope="module")
def chunk():
    return _load("probe_chunk_axial")


@pytest.fixture(scope="module")
def pyr():
    return _load("probe_pyramid_pallas")


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(_np(x)).to(dtype)


def _close(got, ref, tol):
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    err = float(np.abs(got - ref).max())
    assert err <= tol * float(np.abs(ref).max()), (err, float(np.abs(ref).max()))


def _recording_pl(records):
    """A stand-in for a probe's ``pl``: its ``pallas_call`` interprets and
    records (inputs, outputs) of every call."""
    def pallas_call(kernel, **kw):
        call = pl.pallas_call(kernel, interpret=True, **kw)

        def run(*args):
            out = call(*args)
            records.append((args, out))
            return out
        return run
    return types.SimpleNamespace(BlockSpec=pl.BlockSpec, pallas_call=pallas_call)


class _Stop(Exception):
    pass


def _stop(*a, **k):
    raise _Stop


def _locals_at(fn, frame_name, stop_attr, mod, monkeypatch, *args):
    """The locals of ``frame_name`` when it first reaches ``mod.<stop_attr>``
    (a function, or ``pl`` for its first BlockSpec): the probe's inputs,
    right after it has drawn them."""
    stop = types.SimpleNamespace(BlockSpec=_stop, pallas_call=_stop) if stop_attr == "pl" else _stop
    monkeypatch.setattr(mod, stop_attr, stop)
    with pytest.raises(_Stop) as info:
        fn(*args)
    tb = info.value.__traceback__
    while tb is not None:
        if tb.tb_frame.f_code.co_name == frame_name:
            return dict(tb.tb_frame.f_locals)
        tb = tb.tb_next
    raise AssertionError(f"no frame {frame_name}")


SMALL = dict(batch=1, tw=2, grid=8, embed_dim=16, heads=2, chunk=32, steps=1)


# ----------------------------------------------------------------- P1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_within_roll_matches_the_jax_kernel(lane, dtype, monkeypatch):
    """``probe_within_roll``'s kernel (both rolls, the probe's slab) and the
    port's rolls on its input: equal, the two halves of one (2, rows,
    total) buffer, and the probe's own check passes."""
    records = []
    monkeypatch.setattr(lane, "pl", _recording_pl(records))
    ok, _ = lane.probe_within_roll(DTYPES[dtype][0])
    assert ok
    (x,), (o1, o2) = records[0]
    xt = _t(x, DTYPES[dtype][1])
    assert torch.equal(xt, lane_axial.within_roll_input(DTYPES[dtype][1]))
    s = lane_axial.ROLL_SHAPE
    got = lane_axial.within_roll(xt, 5, s.W, 3 * s.W, s.H * s.W)
    assert got[0].data_ptr() == got[0].untyped_storage().data_ptr()
    assert got[1].data_ptr() == got[0].data_ptr() + xt.numel() * xt.element_size()
    for g, want in zip(got, (o1, o2)):
        assert g.dtype == xt.dtype
        np.testing.assert_array_equal(g.float().numpy(), _np(want))


def _lane_core_jax(lane, q, kv, bx, by, sc, heads, h, w):
    bt, c, n = q.shape
    d = c // heads

    def kern(q_ref, kv_ref, bx_ref, by_ref, sc_ref, o_ref):
        lane._core_kernel(q_ref.at[0], kv_ref.at[0], bx_ref, by_ref, sc_ref, o_ref.at[0],
                          heads=heads, d=d, t_len=1, h=h, w=w)

    def const(shape):
        return pl.BlockSpec(shape, lambda i: (0,) * len(shape))

    slab = pl.BlockSpec((1, c, n), lambda i: (i, 0, 0))
    return pl.pallas_call(
        kern, grid=(bt,),
        in_specs=[slab, pl.BlockSpec((1, 2 * c, n), lambda i: (i, 0, 0)),
                  const((w * heads, n)), const((h * heads, n)), const((c, 2))],
        out_specs=slab, out_shape=jax.ShapeDtypeStruct((bt, c, n), q.dtype),
        interpret=True)(q, kv, bx, by, sc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lane_core_matches_the_jax_kernel(lane, dtype):
    """``_core_kernel`` (2 heads of 8 on an 8x16 grid, 2 frames) in
    interpret mode against ``lane_core_plain``."""
    heads, d, h, w, bt = 2, 8, 8, 16, 2
    c, n = heads * d, h * w
    rng = np.random.default_rng(3)
    jdt, tdt = DTYPES[dtype]
    arrs = dict(q=rng.standard_normal((bt, c, n)), kv=rng.standard_normal((bt, 2 * c, n)),
                bx=0.1 * rng.standard_normal((w * heads, n)),
                by=0.1 * rng.standard_normal((h * heads, n)),
                sc=rng.uniform(0.5, 1.5, (c, 2)))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    jx = {k: jnp.asarray(v, jdt if k in ("q", "kv") else jnp.float32) for k, v in arrs.items()}
    want = _lane_core_jax(lane, **jx, heads=heads, h=h, w=w)
    tx = {k: _t(v, tdt if k in ("q", "kv") else torch.float32) for k, v in jx.items()}
    got = lane_axial.lane_core(**tx, heads=heads, h=h, w=w)
    assert got.dtype == tdt
    _close(got, _np(want), TOL[dtype])


def test_lane_make_inputs_are_the_jax_probes_draws(lane, monkeypatch):
    """``make_inputs`` draws what ``bench_core`` draws (read from its frame
    as it builds its first BlockSpec)."""
    args = types.SimpleNamespace(**SMALL)
    loc = _locals_at(lane.bench_core, "bench_core", "pl", lane, monkeypatch, args)
    ours = lane_axial.make_inputs(args)
    assert (ours["heads"], ours["h"], ours["w"]) == (loc["heads"], loc["h"], loc["w"])
    for k in ("q", "kv", "bx", "by", "sc"):
        assert ours[k].dtype == (torch.bfloat16 if k in ("q", "kv") else torch.float32), k
        np.testing.assert_array_equal(ours[k].float().numpy(), _np(loc[k]), err_msg=k)


# P1b's bf16 kernel (core_kernel) at its shape families: head dims 16 and
# 64, H != W, lines that are not a multiple of 16 (12 and 20 tokens) and a
# grid whose width is a multiple of 8 (its 16-byte loads): (heads, d, h, w).
HOPPER_SHAPES = {"d16_ragged": (2, 16, 12, 20), "d64_ragged": (1, 64, 20, 12),
                 "d64_vector": (1, 64, 12, 24)}


def _lane_arrays(seed, heads, d, h, w, bt=2):
    c, n = heads * d, h * w
    rng = np.random.default_rng(seed)
    arrs = dict(q=rng.standard_normal((bt, c, n)), kv=rng.standard_normal((bt, 2 * c, n)),
                bx=0.1 * rng.standard_normal((w * heads, n)),
                by=0.1 * rng.standard_normal((h * heads, n)),
                sc=rng.uniform(0.5, 1.5, (c, 2)))
    return {k: v.astype(np.float32) for k, v in arrs.items()}


def _lane_core_by_lines(q, kv, bx, by, sc, heads, h, w):
    """``bench_core`` as the bf16 kernel computes it: per line, dense
    attention with the line's (query, key) table from ``line_table``, o =
    s_c P v + (1 - s_c) mean(v), the directions averaged (float32)."""
    bt, c, n = q.shape
    d = c // heads
    k, v = kv[:, :c].float(), kv[:, c:].float()
    out = torch.zeros(bt, c, n)
    for axis, length, lines, table in ((0, w, h, bx), (1, h, w, by)):
        for line in range(lines):
            i = torch.arange(length)
            pos = line * w + i if axis == 0 else i * w + line
            for hd in range(heads):
                ch = slice(hd * d, (hd + 1) * d)
                ql, kl, vl = (t[:, ch][:, :, pos].transpose(1, 2) for t in (q.float(), k, v))
                logits = ql @ kl.transpose(1, 2) * d**-0.5 + lane_axial.line_table(
                    table, heads, hd, h, w, axis, line)
                o = torch.softmax(logits, -1) @ vl
                s_c = sc[ch, axis]
                o = s_c * o + (1 - s_c) * vl.mean(1, keepdim=True)
                out[:, ch, pos] += 0.5 * o.transpose(1, 2)
    return out


@pytest.mark.parametrize("case", list(HOPPER_SHAPES))
def test_lane_core_matches_the_jax_kernel_at_the_hopper_shapes(lane, case):
    """``_core_kernel`` in interpret mode, bf16, against ``lane_core_plain``
    (what the wrapper runs on the CPU) within 2e-2, and against the bf16
    kernel's own formulation, line by line through ``line_table``, before
    rounding (float32 sums reordered: 1e-5)."""
    heads, d, h, w = HOPPER_SHAPES[case]
    arrs = _lane_arrays(4, heads, d, h, w)
    jx = {k: jnp.asarray(v, jnp.bfloat16 if k in ("q", "kv") else jnp.float32)
          for k, v in arrs.items()}
    want = _lane_core_jax(lane, **jx, heads=heads, h=h, w=w)
    tx = {k: _t(v, torch.bfloat16 if k in ("q", "kv") else torch.float32) for k, v in jx.items()}
    got = lane_axial.lane_core(**tx, heads=heads, h=h, w=w)
    assert got.dtype == torch.bfloat16
    _close(got, _np(want), TOL["bfloat16"])
    jf = {k: jnp.asarray(_np(v)) for k, v in jx.items()}
    want32 = _lane_core_jax(lane, **jf, heads=heads, h=h, w=w)
    by_lines = _lane_core_by_lines(**{k: v.float() for k, v in tx.items()}, heads=heads, h=h,
                                   w=w)
    _close(by_lines, _np(want32), TOL["float32"])


@pytest.mark.parametrize("axis", [0, 1], ids=["rows", "cols"])
@pytest.mark.parametrize("heads,h,w", [(2, 12, 20), (3, 8, 8), (1, 6, 40)],
                         ids=["12x20", "8x8", "6x40"])
def test_line_table_is_the_jax_kernels_offset_map(lane, axis, heads, h, w):
    """The TPU kernel adds ``table[r * heads + head, p]`` to the logit of the
    query at p and the key ``_within_roll`` brings to p at offset r (rows:
    stride 1 in blocks of w; columns: stride w over the frame): ``line_table``
    puts that entry at (query, key) of the query's line, for every line,
    head and offset."""
    n = h * w
    length, lines = (w, h) if axis == 0 else (h, w)
    table = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (length * heads, n)).astype(np.float32))
    idx = jnp.arange(n, dtype=jnp.float32)[None]
    p = np.arange(n)
    line, i = (p // w, p % w) if axis == 0 else (p % w, p // w)
    want = np.full((heads, lines, length, length), np.nan, np.float32)
    for r in range(length):
        keys = np.asarray(lane._within_roll(idx, r * (1 if axis == 0 else w),
                                            w if axis == 0 else n, n))[0].astype(int)
        j = keys % w if axis == 0 else keys // w
        for head in range(heads):
            want[head, line, i, j] = table[r * heads + head].numpy()
    for head in range(heads):
        for ln in range(lines):
            got = lane_axial.line_table(table, heads, head, h, w, axis, ln)
            np.testing.assert_array_equal(got.numpy(), want[head, ln])


# ----------------------------------------------------------------- P2


def test_dot_combos_matches_the_jax_kernel(chunk, monkeypatch):
    """``probe_dot_combos``' kernel on its slabs: S (float32 sums of exact
    products) and pv (through the bf16-rounded probabilities)."""
    records = []
    monkeypatch.setattr(chunk, "pl", _recording_pl(records))
    ok, _ = chunk.probe_dot_combos()
    assert ok
    (x, y), (s, pv) = records[0]
    xt, yt = _t(x, torch.bfloat16), _t(y, torch.bfloat16)
    ours = chunk_axial.dot_combos_input()
    assert torch.equal(xt, ours[0]) and torch.equal(yt, ours[1])
    s_got, pv_got = chunk_axial.dot_combos(xt, yt)
    _close(s_got, _np(s), TOL["float32"])
    _close(pv_got, _np(pv), TOL["bfloat16"])


def test_perm_matmul_matches_the_jax_kernel_exactly(chunk, monkeypatch):
    records = []
    monkeypatch.setattr(chunk, "pl", _recording_pl(records))
    ok, _ = chunk.probe_perm_matmul()
    assert ok
    (x, p), (o,) = records[0][0], (records[0][1],)
    xt, pt = _t(x, torch.bfloat16), _t(p, torch.bfloat16)
    ours = chunk_axial.perm_input()
    assert torch.equal(xt, ours[0]) and torch.equal(pt, ours[1])
    got = chunk_axial.perm_product(xt, pt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), _np(o))


def _chunk_core_jax(chunk, q, kv, br, bc, mrs, mcs, perm, sc, heads, ch, h, w):
    bt, c, n = q.shape
    d = c // heads

    def kern(q_ref, kv_ref, br_ref, bc_ref, mrs_ref, mcs_ref, perm_ref, sc_ref, o_ref):
        chunk._core_kernel(q_ref.at[0], kv_ref.at[0], br_ref, bc_ref, mrs_ref, mcs_ref,
                           perm_ref, sc_ref, o_ref.at[0], heads=heads, d=d, h=h, w=w, ch=ch)

    def const(shape):
        return pl.BlockSpec(shape, lambda i: (0,) * len(shape))

    slab = pl.BlockSpec((1, c, n), lambda i: (i, 0, 0))
    return pl.pallas_call(
        kern, grid=(bt,),
        in_specs=[slab, pl.BlockSpec((1, 2 * c, n), lambda i: (i, 0, 0)),
                  const((heads * ch, ch)), const((heads * ch, ch)), const((ch, ch)),
                  const((ch, ch)), const((n, n)), const((heads, 2))],
        out_specs=slab, out_shape=jax.ShapeDtypeStruct((bt, c, n), q.dtype),
        interpret=True)(q, kv, br, bc, mrs, mcs, perm, sc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_core_matches_the_jax_kernel(chunk, dtype):
    """``_core_kernel`` (2 heads of 8 on an 8x8 grid, chunks of 32, 2
    frames) in interpret mode against ``chunk_core_plain``, on
    ``make_inputs``' tables."""
    args = types.SimpleNamespace(**SMALL)
    inp = chunk_axial.make_inputs(args)
    jdt, tdt = DTYPES[dtype]
    slabs = ("q", "kv", "perm")
    jx = {k: jnp.asarray(inp[k].float().numpy(), jdt if k in slabs else jnp.float32)
          for k in ("q", "kv", "br", "bc", "mrs", "mcs", "perm", "sc")}
    want = _chunk_core_jax(chunk, **jx, heads=inp["heads"], ch=inp["ch"], h=args.grid,
                           w=args.grid)
    tx = {k: _t(v, tdt if k in slabs else torch.float32) for k, v in jx.items()}
    got = chunk_axial.chunk_core(**tx, heads=inp["heads"], ch=inp["ch"])
    assert got.dtype == tdt
    _close(got, _np(want), TOL[dtype])


def test_chunk_make_inputs_are_the_jax_probes_draws(chunk, monkeypatch):
    args = types.SimpleNamespace(**SMALL)
    loc = _locals_at(chunk.bench_core, "bench_core", "pl", chunk, monkeypatch, args)
    ours = chunk_axial.make_inputs(args)
    assert (ours["heads"], ours["ch"]) == (loc["heads"], loc["ch"])
    for k in ("q", "kv", "br", "bc", "mrs", "mcs", "perm", "sc"):
        want_dt = torch.bfloat16 if k in ("q", "kv", "perm") else torch.float32
        assert ours[k].dtype == want_dt, k
        np.testing.assert_array_equal(ours[k].float().numpy(), _np(loc[k]), err_msg=k)


# ----------------------------------------------------------------- P3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stage_matches_the_jax_kernel(pyr, dtype):
    """``stage_pallas`` (interpreted off the TPU by itself) at bt 2, 16x16,
    8 channels in and out, two row blocks, against ``stage_plain``: the
    folded product and the statistics."""
    rng = np.random.default_rng(5)
    jdt, tdt = DTYPES[dtype]
    y0 = jnp.asarray(rng.standard_normal((2, 16, 16, 8)).astype(np.float32), jdt)
    mean = jnp.asarray(0.1 * rng.standard_normal((2, 8)).astype(np.float32))
    inv = jnp.asarray(rng.uniform(0.8, 1.2, (2, 8)).astype(np.float32))
    k = jnp.asarray((0.05 * rng.standard_normal((2, 2, 8, 8))).astype(np.float32), jdt)
    out, mu, var = pyr.stage_pallas(y0, mean, inv, k, hb=4)
    got = pyramid.stage(_t(y0, tdt), _t(mean), _t(inv), _t(k, tdt))
    assert got[0].dtype == tdt
    _close(got[0], _np(out), TOL[dtype])
    _close(got[1], _np(mu), TOL["float32"])
    _close(got[2], _np(var), TOL["float32"])


def test_stage_make_inputs_are_the_jax_probes_draws(pyr, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["probe", "--bt", "2", "--size", "8", "--cin", "4",
                                      "--cout", "6"])
    loc = _locals_at(pyr.main, "main", "stage_xla", pyr, monkeypatch)
    ours = pyramid.make_inputs(types.SimpleNamespace(bt=2, size=8, cin=4, cout=6))
    for k in ("y0", "mean", "inv", "k"):
        want_dt = torch.bfloat16 if k in ("y0", "k") else torch.float32
        assert ours[k].dtype == want_dt, k
        np.testing.assert_array_equal(ours[k].float().numpy(), _np(loc[k]), err_msg=k)


# ----------------------------------------------------------------- CLIs


@pytest.mark.parametrize("module,argv", [
    (lane_axial, ["--batch", "1", "--tw", "2", "--grid", "8", "--embed-dim", "16",
                  "--heads", "2", "--steps", "1"]),
    (chunk_axial, ["--batch", "1", "--tw", "2", "--grid", "8", "--embed-dim", "16",
                   "--heads", "2", "--chunk", "32", "--steps", "1"]),
    (pyramid, ["--bt", "2", "--size", "16", "--cin", "8", "--cout", "8", "--steps", "1"]),
], ids=["lane_axial", "chunk_axial", "pyramid"])
def test_probe_clis_run_on_the_cpu(module, argv, capsys):
    """Each CLI's ``main`` at ``--device cpu``: its checks pass and it prints
    one JSON line with no device time; without ``--device`` it asks for a
    card."""
    results = module.main(argv + ["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    if module is pyramid:
        assert line["agreement_out"] == 0.0 and line["kernel_fwd_ms"] is None
    else:
        assert all(ok for k, ok in results.items() if k != "bench")
        assert line == results["bench"] and line["ms_per_call"] is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            module.main(argv)
