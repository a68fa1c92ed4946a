"""bubbleformer_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of
``bubbleformer_tpu``.

The JAX package beside this one is the reference: every module here mirrors
its counterpart there (same file names under ``layers/``, ``ops/``,
``models/``, ``inference/``, ``utils/``, ``config/`` and ``data/``) and the
port's ``state_dict`` keys are the reference torch model's, so
``bubbleformer_tpu/utils/convert.py:convert_avit_state_dict`` maps port
weights straight into JAX params and ``utils/convert.py`` here maps them
back.

This package imports ``torch`` and never ``jax``.  The Pallas kernels of the
JAX package's main path are hand-written CUDA C++ for ``sm_90a`` under
``csrc/``, built with ``nvcc`` at first use (``_build.py``).  On CPU tensors
every kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"
