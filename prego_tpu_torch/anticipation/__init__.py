from prego_tpu_torch.anticipation.cleaning import clean_generation
from prego_tpu_torch.anticipation.driver import (
    AnticipationResult,
    anticipate_sequence,
    get_toy,
    run_anticipation,
    save_results,
)
from prego_tpu_torch.anticipation.llm import (
    FakeLLM,
    HFPipelineLLM,
    OllamaLLM,
    TorchLlamaLLM,
    build_llm,
)
from prego_tpu_torch.anticipation.prompts import (
    DEFAULT_CONTEXT_STYLES,
    PromptBuilder,
    load_context_styles,
    remove_sequence_input,
    symbolize_sequence,
)

__all__ = [
    "clean_generation",
    "AnticipationResult",
    "anticipate_sequence",
    "get_toy",
    "run_anticipation",
    "save_results",
    "FakeLLM",
    "HFPipelineLLM",
    "OllamaLLM",
    "TorchLlamaLLM",
    "build_llm",
    "DEFAULT_CONTEXT_STYLES",
    "PromptBuilder",
    "load_context_styles",
    "remove_sequence_input",
    "symbolize_sequence",
]
