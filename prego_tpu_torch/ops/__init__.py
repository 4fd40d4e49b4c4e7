"""Tensor ops of the port. Kernel wrappers (gru_cuda, gru_cuda_vjp,
decode_attention, decode_attention_wo, decode_attention_q8, fused_ffn,
fused_dense, quant) launch their CUDA kernel on a CUDA tensor and run their plain
PyTorch version on a CPU tensor."""

from prego_tpu_torch.ops.gru import gru_cell, gru_scan, init_gru_params

__all__ = ["gru_cell", "gru_scan", "init_gru_params", "kernels"]


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
