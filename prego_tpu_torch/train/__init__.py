from prego_tpu_torch.train.evaluator import (
    Evaluator,
    make_chunk_fn,
    streaming_scores,
    streaming_scores_lazy,
)

__all__ = ["Evaluator", "make_chunk_fn", "streaming_scores", "streaming_scores_lazy"]
