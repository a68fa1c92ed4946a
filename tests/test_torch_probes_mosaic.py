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
kernels' layout, within the probe's own bounds.
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
