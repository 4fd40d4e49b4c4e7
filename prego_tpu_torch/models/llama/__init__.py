from prego_tpu_torch.models.llama.config import LlamaConfig, tiny_test_config
from prego_tpu_torch.models.llama.generation import Llama
from prego_tpu_torch.models.llama.model import (
    forward,
    fuse_projections,
    init_cache,
    init_params,
    precompute_rope,
)
from prego_tpu_torch.models.llama.tokenizer import (
    ByteTokenizer,
    HFTokenizer,
    SentencePieceTokenizer,
    load_tokenizer,
)

__all__ = [
    "LlamaConfig",
    "tiny_test_config",
    "Llama",
    "forward",
    "fuse_projections",
    "init_cache",
    "init_params",
    "precompute_rope",
    "ByteTokenizer",
    "HFTokenizer",
    "SentencePieceTokenizer",
    "load_tokenizer",
]
