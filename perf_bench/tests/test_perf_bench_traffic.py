"""The general generator: the same seed gives the same traffic, another
seed the same sizes with other content."""

from __future__ import annotations

import json

import numpy as np
import pytest

from conftest import BENCH_DIR
from perf_bench import gen
from perf_bench.reference import prompts as ref_prompts

COLLECTION = json.loads((BENCH_DIR / "traffic" / "offline-collection.json").read_text())
FEATURES = json.loads((BENCH_DIR / "traffic" / "asm101-o-features.json").read_text())
BIG = 2 ** 31 + 12345  # seeds run past 32 signed bits


@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_collection_repeats_per_seed(seed):
    a, b = gen.make_collection(COLLECTION, seed), gen.make_collection(COLLECTION, seed)
    assert a == b


def test_collection_sizes_do_not_depend_on_the_seed():
    a, b = gen.make_collection(COLLECTION, 1), gen.make_collection(COLLECTION, BIG)
    assert [len(c) for c in a.contexts] == [len(c) for c in b.contexts]
    assert [(t, len(s)) for t, s in a.videos] == [(t, len(s)) for t, s in b.videos]
    assert a.contexts != b.contexts and a.videos != b.videos
    lo, hi = COLLECTION["context_tokens"]
    assert [len(c) for c in a.contexts] == [int(x) for x in np.round(np.linspace(lo, hi, 8))]
    steps = sorted(len(s) for _, s in a.videos)
    assert steps[0] == COLLECTION["steps"][0] and steps[-1] == COLLECTION["steps"][1]


def test_prompts_fit_the_cache():
    coll = gen.make_collection(COLLECTION, 3)
    longest = max(len(ref_prompts.ids(ref_prompts.step_prompt(coll.contexts[t], coll.toys[t], s,
                                                              len(s) - 1)))
                  for t, s in coll.videos)
    assert longest + COLLECTION["max_gen_len"] <= COLLECTION["max_seq_len"]


def test_prompt_matches_the_ports_step_prompt():
    from prego_tpu_torch.anticipation.prompts import PromptBuilder

    coll = gen.make_collection(COLLECTION, 5)
    toy, seq = coll.videos[0]
    port = PromptBuilder(context=coll.contexts[toy], toy=coll.toys[toy])
    for i in range(len(seq)):
        assert port.step_prompt(seq, i) == ref_prompts.step_prompt(
            coll.contexts[toy], coll.toys[toy], seq, i)


@pytest.mark.parametrize("seed", [4, BIG])
def test_feature_videos_repeat_per_seed(tmp_path, seed):
    t = {**FEATURES, "videos": 3, "frames": [50, 90], "segment_frames": [10, 30]}
    a = gen.write_feature_videos(t, seed, str(tmp_path / "a"), "rgb", 5, 8)
    b = gen.write_feature_videos(t, seed, str(tmp_path / "b"), "rgb", 5, 8)
    assert a == b
    for vid in a:
        for sub in ("rgb", "target_perframe"):
            np.testing.assert_array_equal(np.load(tmp_path / "a" / sub / f"{vid}.npy"),
                                          np.load(tmp_path / "b" / sub / f"{vid}.npy"))
    c = gen.write_feature_videos(t, seed + 1, str(tmp_path / "c"), "rgb", 5, 8)
    assert c == a  # the same frame counts from another seed
    labels = np.load(tmp_path / "a" / "target_perframe" / f"{sorted(a)[0]}.npy").argmax(1)
    assert (labels != 0).all()  # steps, no background
    runs = np.flatnonzero(np.diff(labels)) + 1
    assert (np.diff(np.concatenate([[0], runs, [len(labels)]]))[:-1] >= 10).all()


def test_fixed_sizes_are_the_same_multiset_in_a_fixed_order():
    assert gen.fixed_sizes(8, 32, 25, salt=2) == gen.fixed_sizes(8, 32, 25, salt=2)
    assert sorted(gen.fixed_sizes(8, 32, 25, salt=2)) == list(range(8, 33))


def test_streams_repeat_per_seed_and_cut_where_the_file_says():
    t = {**json.loads((BENCH_DIR / "traffic" / "camera-streams.json").read_text()),
         "streams": 3, "block_frames": 20, "blocks": 6, "video_blocks": [2, 3],
         "segment_frames": [20, 60], "noise": 0.0}
    a, b = gen.make_streams(t, 3, 5, 4), gen.make_streams(t, 3, 5, 4)
    assert a.starts == b.starts and a.toy_of == b.toy_of
    for x, y in zip(a.features, b.features):
        np.testing.assert_array_equal(x, y)
    c = gen.make_streams(t, BIG, 5, 4)
    assert c.starts == a.starts  # the same videos from another seed

    def boundaries(s):  # where a stream's frame changes, noise 0
        x = np.concatenate(s.features)[:, :, 0]
        return [set(np.flatnonzero(np.diff(x[:, j]) != 0)) for j in range(x.shape[1])]

    # another seed's labels may repeat across a cut; its cuts are a's
    for ba, bc in zip(boundaries(a), boundaries(c)):
        assert bc <= ba | {k * 20 - 1 for k in range(1, 7)}
