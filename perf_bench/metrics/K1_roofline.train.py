"""K1 (the GRU recurrence, csrc/gru.cu) against its bound in the traced
training steps: h W_hh a frame, the input gates in, W_hh in, the states out
(moves train_windows_per_s)."""

from perf_bench import readers, yardstick


def read(loop):
    if loop.trace is None:
        return None
    ks = loop.trace.kernels(*readers.K1)
    cfg = loop.cfg
    bound = yardstick.bound_s(*yardstick.gru_fwd_launch(cfg.batch_size, cfg.window_size,
                                                        cfg.hidden_dim))
    return readers.roofline([bound] * len(ks), [(k[1], k[2]) for k in ks])
