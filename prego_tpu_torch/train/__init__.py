from prego_tpu_torch.train.evaluator import (
    Evaluator,
    make_chunk_fn,
    streaming_scores,
    streaming_scores_lazy,
)
from prego_tpu_torch.train.loss import l2_normalize, last_frame_mlce
from prego_tpu_torch.train.lr_schedule import warmup_cosine_schedule
from prego_tpu_torch.train.trainer import (
    build_optimizer,
    make_train_step,
    train_one_epoch,
    update_count,
)

__all__ = [
    "Evaluator",
    "make_chunk_fn",
    "streaming_scores",
    "streaming_scores_lazy",
    "l2_normalize",
    "last_frame_mlce",
    "warmup_cosine_schedule",
    "build_optimizer",
    "make_train_step",
    "train_one_epoch",
    "update_count",
]
