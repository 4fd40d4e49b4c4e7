from prego_tpu_torch.core.config import RecognitionConfig, parse_overrides
from prego_tpu_torch.core.device import resolve_device
from prego_tpu_torch.core.logging import get_logger
from prego_tpu_torch.core.outdir import create_outdir
from prego_tpu_torch.core.registry import (
    CRITERIONS,
    EVALUATORS,
    LLMS,
    MODELS,
    TRAINERS,
    Registry,
)
from prego_tpu_torch.core.seed import make_generator, set_seed

__all__ = [
    "RecognitionConfig",
    "parse_overrides",
    "resolve_device",
    "get_logger",
    "create_outdir",
    "Registry",
    "MODELS",
    "EVALUATORS",
    "TRAINERS",
    "CRITERIONS",
    "LLMS",
    "make_generator",
    "set_seed",
]
