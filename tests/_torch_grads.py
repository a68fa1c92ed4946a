"""Gradient comparison shared by the port's gradient tests."""
import numpy as np
import torch


ZERO_GRADS = ("kn_bias",)


def check_grads(names, got, want, tol, zero_noise=False):
    """Each gradient in ``got`` within ``tol`` of ``want``, relative to its
    own largest magnitude.  A gradient in ``ZERO_GRADS`` is zero up to
    rounding on both sides (the k-LayerNorm bias: a shift of every key
    leaves the softmax unchanged) and has no scale of its own: it is held
    to a hundredth of the largest magnitude of all ``want`` gradients.

    ``zero_noise``: where the two sides' rounding noise is uncorrelated (K5
    in bfloat16: its ``dao`` comes out of an InstanceNorm backward whose
    reassociated sums flip bfloat16 roundings; K9 in bfloat16: its qkv comes
    out of projections summed in other orders; so the zero gradient is
    independent noise on each side), such a gradient is held to the
    reference's own noise instead: at most three times its largest
    magnitude, plus ``tol`` of the floor."""
    want = [np.asarray(w, np.float64) for w in want]
    floor = 1e-2 * max(np.abs(w).max() for w in want)
    for name, g, w in zip(names, got, want):
        g = np.asarray(g.detach().double() if isinstance(g, torch.Tensor) else g, np.float64)
        assert g.shape == w.shape, name
        if zero_noise and name in ZERO_GRADS:
            assert np.abs(g).max() <= 3 * np.abs(w).max() + tol * floor, (name, np.abs(g).max())
            continue
        err = np.abs(g - w).max() / (floor if name in ZERO_GRADS else np.abs(w).max())
        assert err <= tol, (name, err)


class single_thread:
    """Run a block on one CPU thread: bit-for-bit comparisons between two
    computations must not depend on how many threads MKL picks under the
    machine's load (it may use fewer than asked, which reorders sums)."""

    def __enter__(self):
        self.threads = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.threads)
