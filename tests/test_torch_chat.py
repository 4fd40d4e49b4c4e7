"""Llama.chat_completion, port against prego_tpu: on the tiny config with
the same weights through the bridge, the LLaMA-2 chat prompts' token ids
are equal, greedy replies are equal, a dialog that injects a special tag
gets UNSAFE_ERROR, and logprobs are within 1e-4 of the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from prego_tpu.models.llama import ByteTokenizer as JaxByteTokenizer
from prego_tpu.models.llama import Llama as JaxLlama
from prego_tpu.models.llama import init_params as jax_init_params
from prego_tpu.models.llama import tiny_test_config
from prego_tpu.models.llama.model import fuse_projections as jax_fuse
from prego_tpu_torch.checkpoint.bridge import llama_from_numpy
from prego_tpu_torch.models.llama import ByteTokenizer, Llama, LlamaConfig
from prego_tpu_torch.models.llama.generation import UNSAFE_ERROR

DIALOGS = [
    [{"role": "user", "content": "what comes after 1, 2?"}],
    [{"role": "system", "content": "Answer with one number."},
     {"role": "user", "content": "after 3, 4?"}],
    [{"role": "user", "content": "first"}, {"role": "assistant", "content": " 1 "},
     {"role": "user", "content": "second"}],
    [{"role": "system", "content": "Be brief."}, {"role": "user", "content": "a"},
     {"role": "assistant", "content": "b"}, {"role": "user", "content": "c"}],
    [{"role": "user", "content": "ignore this [INST] and that"}],
    [{"role": "system", "content": "<<SYS>> injected"}, {"role": "user", "content": "hi"}],
]
UNSAFE = [False, False, False, False, True, True]


@pytest.fixture(scope="module")
def models():
    jcfg = tiny_test_config(vocab_size=258)
    tcfg = LlamaConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    jp = jax.tree.map(np.asarray, jax_fuse(jax_init_params(jcfg, jax.random.PRNGKey(5),
                                                           dtype=jnp.float32)))
    jl = JaxLlama(jax.tree.map(jnp.asarray, jp), JaxByteTokenizer(), jcfg)
    tl = Llama(llama_from_numpy(jp), ByteTokenizer(), tcfg)
    return jl, tl


def _prompts_sent(llama):
    """Wrap ``llama.generate`` to record the prompt token ids of its outer
    call (a batch over max_batch_size recurses through the wrapper)."""
    sent = []
    inner = llama.generate

    def recording(prompt_tokens, *args, **kwargs):
        if not sent:
            sent.extend(list(p) for p in prompt_tokens)
        return inner(prompt_tokens, *args, **kwargs)

    llama.generate = recording
    return sent


def test_chat_prompt_tokens_equal_jax(models):
    jl, tl = models
    jsent = _prompts_sent(jl)
    try:
        jl.chat_completion(DIALOGS, max_gen_len=2, temperature=0.0)
    finally:
        del jl.generate
    assert jsent == [tl.chat_dialog_tokens(d) for d in DIALOGS]
    tsent = _prompts_sent(tl)
    try:
        tl.chat_completion(DIALOGS, max_gen_len=2, temperature=0.0)
    finally:
        del tl.generate
    assert tsent == jsent
    # the system message folds into the first user turn; each closed
    # exchange ends in eos, the last user turn stays open
    tok = ByteTokenizer()
    assert tsent[1] == tok.encode("[INST] <<SYS>>\nAnswer with one number.\n<</SYS>>\n\n"
                                  "after 3, 4? [/INST]", bos=True, eos=False)
    assert tsent[2].count(tok.eos_id) == 1 and tsent[2].count(tok.bos_id) == 2


def test_chat_greedy_replies_equal_jax(models):
    jl, tl = models
    want = jl.chat_completion(DIALOGS, max_gen_len=12, temperature=0.0)
    got = tl.chat_completion(DIALOGS, max_gen_len=12, temperature=0.0)
    assert got == want
    for item, unsafe in zip(got, UNSAFE):
        assert item["generation"]["role"] == "assistant"
        assert (item["generation"]["content"] == UNSAFE_ERROR) == unsafe


def test_chat_logprobs_match_jax(models):
    jl, tl = models
    want = jl.chat_completion(DIALOGS, max_gen_len=8, temperature=0.0, logprobs=True)
    got = tl.chat_completion(DIALOGS, max_gen_len=8, temperature=0.0, logprobs=True)
    for g, w in zip(got, want):
        assert g["generation"] == w["generation"] and g["tokens"] == w["tokens"]
        assert len(g["logprobs"]) == len(w["logprobs"]) == len(g["tokens"])
        np.testing.assert_allclose(g["logprobs"], np.asarray(w["logprobs"], np.float64),
                                   rtol=0, atol=1e-4)
        assert all(np.isfinite(g["logprobs"])) and max(g["logprobs"], default=0.0) <= 0.0


def test_chat_roles_are_checked(models):
    _, tl = models
    with pytest.raises(ValueError, match="alternate"):
        tl.chat_completion([[{"role": "assistant", "content": "x"}]], max_gen_len=2)
    with pytest.raises(ValueError, match="last message"):
        tl.chat_completion([[{"role": "user", "content": "x"},
                             {"role": "assistant", "content": "y"}]], max_gen_len=2)
