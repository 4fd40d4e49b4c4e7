"""K6 (the GRU recurrence's backward, csrc/gru_bwd.cu) against its bound in
the traced training steps: the gate recompute and the dh chain a frame
(moves train_windows_per_s)."""

from perf_bench import readers, yardstick


def read(loop):
    if loop.trace is None:
        return None
    ks = loop.trace.kernels(*readers.K6)
    cfg = loop.cfg
    bound = yardstick.bound_s(*yardstick.gru_bwd_launch(cfg.batch_size, cfg.window_size,
                                                        cfg.hidden_dim))
    return readers.roofline([bound] * len(ks), [(k[1], k[2]) for k in ks])
