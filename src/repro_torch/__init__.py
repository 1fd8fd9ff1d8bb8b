"""PyTorch/CUDA port of the ``repro`` package.

The JAX package ``repro`` is the reference; this package mirrors its
module paths (``repro_torch.models.cnn.executor`` is the counterpart of
``repro.models.cnn.executor``) and keeps its layouts (NHWC activations,
HWIO weights, the same nested parameter tree).  It imports ``torch`` and
nothing of ``repro`` or ``jax``.  The Pallas TPU kernels on its path are
hand-written CUDA C++ kernels for Hopper under ``csrc/``.
"""
