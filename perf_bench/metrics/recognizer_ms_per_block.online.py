"""Host milliseconds of a block outside its completion call: the per-frame
recognizer steps of every stream, the vote and the host's read, over the
blocks the profiler did not trace (all, where it traced every one) (moves online_frames_per_s)."""


def read(loop):
    blocks = [b for b in loop.blocks if not b.traced] or loop.blocks
    if not blocks:
        return None
    return 1000.0 * sum(b.seconds - b.llm_seconds for b in blocks) / len(blocks)
