"""Model FLOPs of the traced blocks over the traced window, against the bf16
dense peak: the recognizer's per-frame step for every stream and frame,
and each block's completion call as in the anticipation cell (moves
online_frames_per_s)."""

from perf_bench import readers, yardstick


def read(loop):
    rc, t = loop.rc, loop.t
    frame = yardstick.miniroad_frame_flops(rc["rgb_dim"], rc["embedding_dim"], rc["hidden_dim"],
                                           rc["num_classes"])
    flops = 0.0
    for blk in loop.traced_calls:
        flops += frame * int(t["streams"]) * int(t["block_frames"])
        if blk.events:
            flops += yardstick.llama_call_flops(loop.c, loop.prompt_ids(blk),
                                                [len(s) for s in blk.served])
    return readers.mfu(loop, flops)
