"""Plain references in PyTorch and NumPy, float32 with TF32 off.

They import neither ``jax``, the JAX package nor anything of the port,
and take nothing the port made: the harness hands them the inputs and
weights it drew, and they work out again whatever the port derived.
"""

import torch


def f32_exact() -> None:
    """float32 products stay float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
