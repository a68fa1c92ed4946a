"""The layout probes' kernels (P4) against ``scripts/probe_mosaic.py``.

The JAX probe runs its 14 kernel bodies through one ``pallas_call``
(``_run``); here ``_run`` is swapped for one that interprets on the CPU and
records each body's input and output.  Each recorded input is the port's
``body_input`` for that body, and the port's body on it (its kernels' plain
versions, as the wrappers run them on the CPU) gives the recorded output:
exactly for the copies, within 1e-5 of the largest magnitude for the float32
Gram products (summation order) and 2e-2 for the bf16 per-head products
(single-ulp bf16 flips where reassociated float32 sums straddle a rounding
edge).  The two per-head dot bodies' JAX references raise (they stack the
heads on axis 2 and then transpose, ``probe_mosaic.py:254``, ``:304``); the
JAX kernels' outputs are held to the port's references, which keep the
kernels' layout, within the probe's own bounds.  The float32 Gram kernel's
3xTF32 split, emulated with ``mosaic.tf32_round``, meets the JAX probe's
absolute 1e-3 on each Gram body where one TF32 pass does not.
"""
import contextlib
import importlib.util
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bubbleformer_tpu_torch.probes import mosaic

REPO = Path(__file__).resolve().parents[1]
BROKEN = ("head_slice_dot_bf16", "chunked_ref_reads_bf16")
GRAM_BODIES = [name for name, kernel in mosaic.BODY_KERNEL.items() if kernel == "gram"]


@pytest.fixture(scope="module")
def recorded():
    """Import the JAX probe once (its module-level probes print, and fail
    off the TPU, at import), then run every probe with ``_run`` interpreted:
    {body name: (input, output) as float32 numpy, the probe's result or the
    exception its reference raised}."""
    saved = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location("probe_mosaic", REPO / "scripts"
                                                  / "probe_mosaic.py")
    probe = importlib.util.module_from_spec(spec)
    with contextlib.redirect_stdout(io.StringIO()):
        spec.loader.exec_module(probe)
    jax.config.update("jax_compilation_cache_dir", saved)
    records = {}

    def run(kernel, x, out_shape):
        out = pl.pallas_call(kernel, out_shape=out_shape, interpret=True)(x)
        name = kernel.__qualname__.split(".")[0].removeprefix("probe_")
        records[name] = tuple(np.array(jnp.asarray(a).astype(jnp.float32)) for a in (x, out))
        return out

    probe._run = run
    results = {}
    for name in mosaic.BODIES:
        try:
            results[name] = getattr(probe, f"probe_{name}")()
        except TypeError as e:
            results[name] = e
    return records, results


@pytest.mark.parametrize("name", list(mosaic.BODIES))
def test_body_matches_the_jax_kernel(recorded, name):
    records, _ = recorded
    x, want = records[name]
    dtype = mosaic.BODIES[name][3]
    xt = mosaic.body_input(name)
    assert xt.dtype == dtype and torch.equal(xt, torch.from_numpy(x).to(dtype))
    got = mosaic.run_body(name, xt)
    assert got.shape == want.shape
    got = got.float().numpy()
    kernel = mosaic.BODY_KERNEL[name]
    if kernel == "view_copy":
        np.testing.assert_array_equal(got, want)
    else:
        tol = 2e-2 if kernel == "chunk_gram_apply" else 1e-5
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_the_jax_probes_pass_but_the_two_broken_references(recorded):
    """Twelve JAX probes pass on the interpreted kernels; the two per-head
    dot probes raise in their references, not in their kernels."""
    _, results = recorded
    for name, res in results.items():
        if name in BROKEN:
            assert isinstance(res, TypeError) and "incompatible shapes" in str(res), res
        else:
            assert res[0], (name, res)


@pytest.mark.parametrize("name", BROKEN)
def test_the_broken_probes_kernels_compute_the_corrected_reference(recorded, name):
    """The JAX kernel's output against the reference without the stray
    transpose, within the probe's bound; and the port's check of its own
    body passes on the CPU."""
    records, _ = recorded
    x, want = records[name]
    ref, bound, relative = mosaic.reference(name, mosaic.body_input(name))
    assert relative and ref.shape == want.shape
    assert np.abs(want - ref.numpy()).max() / np.abs(ref.numpy()).max() < bound
    ok, detail = getattr(mosaic, f"probe_{name}")("cpu")
    assert ok, detail


@pytest.mark.parametrize("name", GRAM_BODIES)
def test_three_tf32_products_meet_the_jax_probes_bound_and_one_does_not(recorded, name):
    """a = hi + lo, hi = tf32(a), lo = tf32(a - hi): lo . hi^T + hi . lo^T +
    hi . hi^T (the float32 kernel's three TF32 products, each exact in
    float32) within the probe's 1e-3 of the JAX body's output and 1e-4 of
    its largest magnitude (the card tests' bound); hi . hi^T alone misses
    1e-3 on the float32 bodies.  bfloat16 values are TF32 values: lo is 0
    (the bfloat16 kernel takes them as they are)."""
    records, _ = recorded
    x, want = records[name]
    a = torch.from_numpy(x).reshape(-1, mosaic.D)
    hi = mosaic.tf32_round(a)
    lo = mosaic.tf32_round(a - hi)
    assert torch.equal(mosaic.tf32_round(hi), hi) and torch.equal(mosaic.tf32_round(lo), lo)
    three = (lo @ hi.t() + hi @ lo.t() + hi @ hi.t()).numpy()
    one = (hi @ hi.t()).numpy()
    err3, err1 = np.abs(three - want).max(), np.abs(one - want).max()
    assert err3 < 1e-3 and err3 <= 1e-4 * np.abs(want).max(), err3
    if mosaic.BODIES[name][3] == torch.bfloat16:
        assert torch.equal(hi, a) and not lo.any()
    else:
        assert err1 > 1e-3, err1


def test_tf32_round_rounds_to_nearest_ties_away():
    """10 mantissa bits: 1 + 2^-12 down, the tie 1 + 2^-11 away from zero
    (either sign), 1 + 3 * 2^-12 up; zero, infinities and exact values
    kept."""
    ulp = 2.0**-10
    x = torch.tensor([1 + 2.0**-12, 1 + 2.0**-11, -(1 + 2.0**-11), 1 + 3 * 2.0**-12, 0.0,
                      float("inf"), -float("inf"), 3 * ulp, -1.5])
    want = torch.tensor([1.0, 1 + ulp, -(1 + ulp), 1 + ulp, 0.0, float("inf"), -float("inf"),
                         3 * ulp, -1.5])
    assert torch.equal(mosaic.tf32_round(x), want)


def test_probe_cli_runs_on_the_cpu(capsys):
    """``main`` at ``--device cpu``: every body OK, one line each in the JAX
    probe's words; without ``--device`` it asks for a card."""
    results = mosaic.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(results) == 14 and all(ok for ok, _ in results.values())
    assert lines == [f"{label}: OK {results[n][1]}" for n, (label, *_) in mosaic.BODIES.items()]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            mosaic.main([])
