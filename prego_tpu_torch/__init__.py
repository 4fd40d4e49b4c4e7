"""prego_tpu_torch — the PyTorch/CUDA port of prego_tpu.

The JAX package ``prego_tpu`` is the reference; this package mirrors its
layout (core, ops, models, train, anticipation, checkpoint, cli) and is
held against it by the ``tests/test_torch_*.py`` parity tests. It imports
torch and never jax. The TPU kernels of the main path are hand-written
CUDA for Hopper (``csrc/``), built with nvcc on first use.
"""

__version__ = "0.1.0"
