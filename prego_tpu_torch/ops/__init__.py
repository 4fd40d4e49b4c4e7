"""Tensor ops of the port. Kernel wrappers (gru_cuda, gru_cuda_vjp,
decode_attention, fused_ffn) launch their CUDA kernel on a CUDA tensor and run their plain
PyTorch version on a CPU tensor."""

from prego_tpu_torch.ops.gru import gru_cell, gru_scan, init_gru_params

__all__ = ["gru_cell", "gru_scan", "init_gru_params", "kernels"]


def kernels():
    """The CudaKernel of every ported TPU kernel, by name."""
    from prego_tpu_torch.ops import decode_attention, fused_ffn, gru_cuda, gru_cuda_vjp

    return {
        "gru_recurrence": gru_cuda.KERNEL,
        "gru_bwd": gru_cuda_vjp.KERNEL,
        "decode_attention": decode_attention.KERNEL,
        "fused_ffn_block": fused_ffn.KERNEL,
    }
