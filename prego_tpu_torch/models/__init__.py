from prego_tpu_torch.models.miniroad import MiniROAD
from prego_tpu_torch.models.miniroad_a import MiniROADA
from prego_tpu_torch.models.transformer import TransformerRecognizer

__all__ = ["MiniROAD", "MiniROADA", "TransformerRecognizer"]
