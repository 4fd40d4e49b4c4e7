"""Tensor ops of the port. Kernel wrappers (gru_cuda, gru_cuda_vjp,
decode_attention, decode_attention_wo, decode_attention_q8, fused_ffn,
fused_dense, quant) launch their CUDA kernel on a CUDA tensor and run their plain
PyTorch version on a CPU tensor."""

from prego_tpu_torch.ops.gru import gru_cell, gru_scan, init_gru_params

__all__ = ["gru_cell", "gru_scan", "init_gru_params", "kernel_launches", "kernels",
           "reset_launches"]


def kernels():
    """The CudaKernel of every ported TPU kernel, by name."""
    from prego_tpu_torch.ops import (
        decode_attention, decode_attention_q8, decode_attention_wo, fused_dense, fused_ffn,
        gru_cuda, gru_cuda_vjp, quant,
    )

    return {
        "gru_recurrence": gru_cuda.KERNEL,
        "gru_bwd": gru_cuda_vjp.KERNEL,
        "decode_attention": decode_attention.KERNEL,
        "fused_ffn_block": fused_ffn.KERNEL,
        "decode_attention_q8": decode_attention_q8.KERNEL,
        "int8_matmul": quant.KERNEL_W8,
        "int8xint8_matmul": quant.KERNEL_W8A8,
        "decode_attention_wo": decode_attention_wo.KERNEL,
        "decode_attention_wo_res_upd": decode_attention_wo.KERNEL_UPD,
        "fused_ffn": fused_ffn.KERNEL_FFN,
        "fused_dense_q8": fused_dense.KERNEL,
        "fused_ffn_block_q8": fused_ffn.KERNEL_Q8,
        "decode_attention_q8_mxu": decode_attention_q8.KERNEL_MXU,
    }


def kernel_launches():
    """The launches each ported TPU kernel has made, by ``kernels()``'s
    names; K7a's ("fused_ffn_block") are its ring's (``fused_ffn.KERNEL_BLOCK``,
    in K7's library) and its first design's together."""
    from prego_tpu_torch.ops import fused_ffn

    counts = {name: k.launches for name, k in kernels().items()}
    counts["fused_ffn_block"] += fused_ffn.KERNEL_BLOCK.launches
    return counts


def reset_launches():
    """Every kernel library's launch count to 0."""
    from prego_tpu_torch.ops._cuda import CudaKernel

    kernels()  # imports every wrapper, so that each library is counted
    for k in CudaKernel.instances:
        k.launches = 0
