from prego_tpu_torch.checkpoint.io import load_checkpoint, load_params, save_checkpoint

__all__ = ["load_checkpoint", "load_params", "save_checkpoint"]
