from prego_tpu_torch.train.evaluator import (
    AntEvaluator,
    Evaluator,
    make_chunk_fn,
    streaming_scores,
    streaming_scores_lazy,
)
from prego_tpu_torch.train.loss import anticipation_mlce, l2_normalize, last_frame_mlce
from prego_tpu_torch.train.lr_schedule import warmup_cosine_schedule
from prego_tpu_torch.train.trainer import (
    ant_train_one_epoch,
    build_optimizer,
    make_ant_train_step,
    make_train_step,
    train_one_epoch,
    update_count,
)

__all__ = [
    "AntEvaluator",
    "Evaluator",
    "make_chunk_fn",
    "streaming_scores",
    "streaming_scores_lazy",
    "anticipation_mlce",
    "l2_normalize",
    "last_frame_mlce",
    "warmup_cosine_schedule",
    "ant_train_one_epoch",
    "build_optimizer",
    "make_ant_train_step",
    "make_train_step",
    "train_one_epoch",
    "update_count",
]
