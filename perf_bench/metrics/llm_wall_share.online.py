"""The share of a block's host clock spent inside the completion call, over
the blocks the profiler did not trace (all, where it traced every one) (the benchmark's spans around the LLM
handed to the detector; moves online_frames_per_s)."""


def read(loop):
    blocks = [b for b in loop.blocks if not b.traced] or loop.blocks
    wall = sum(b.seconds for b in blocks)
    if not blocks or wall <= 0:
        return None
    return 100.0 * sum(b.llm_seconds for b in blocks) / wall
