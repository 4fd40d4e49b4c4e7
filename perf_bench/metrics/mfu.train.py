"""Model FLOPs of the traced training steps (forward and backward, the
recipe's batch and window) over the traced window, against the bf16 dense
peak, though the step's products outside the GRU are float32 (moves
train_windows_per_s)."""

from perf_bench import readers, yardstick


def read(loop):
    rc, cfg = loop.rc, loop.cfg
    flops = loop.steps_in_trace() * yardstick.miniroad_step_flops(
        cfg.batch_size, cfg.window_size, rc["rgb_dim"], rc["embedding_dim"], rc["hidden_dim"],
        rc["num_classes"])
    return readers.mfu(loop, flops)
