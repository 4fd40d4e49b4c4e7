from prego_tpu_torch.models.miniroad import MiniROAD

__all__ = ["MiniROAD"]
