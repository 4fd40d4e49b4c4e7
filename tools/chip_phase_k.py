"""Phase (k) of chip_smoke.py alone, on one card:

  python3 tools/chip_phase_k.py

Builds the kernels, records the prompts of the anticipation loop (FakeLLM
through run_anticipation over tests/golden/synth_seqs.json), writes (h)'s
2-layer 7B-width checkpoint, which (k1) reads, then runs (k4) (a profiler
trace of 7B bf16 decode steps) and (k1)-(k3) (tp, dp and sp ranks as
processes on the card), and prints each part's summary line and the
ranks' launch counts.
"""

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    from prego_tpu_torch.anticipation import run_anticipation
    from prego_tpu_torch.anticipation.llm import FakeLLM, TorchLlamaLLM

    if not torch.cuda.is_available():
        print("chip_phase_k: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    cs.run_phase("build", cs.build_kernels)
    seqs = json.loads((REPO / "tests" / "golden" / "synth_seqs.json").read_text())
    sent = []

    class Recording(FakeLLM):
        def text_completion(self, prompts, **kw):
            sent.append((list(prompts), kw))
            return super().text_completion(prompts, **kw)

    run_anticipation(seqs, Recording(), dataset="synthcustom", max_gen_len=8, num_samples=1,
                     eval_metrics=False)
    cs.run_phase("(h)", lambda: cs.run_checkpoint_load(dev))
    llm = TorchLlamaLLM(fabricated="7b", device=dev)
    cs.run_phase("(k4)", lambda: cs.run_profiling(dev, llm.llama))
    del llm
    torch.cuda.empty_cache()
    _, counts = cs.run_phase("(k1)-(k3)", lambda: cs.run_parallel(
        dev, sent, str(cs.WORK / "ckpt_7b_2layers")))
    print(json.dumps({"parallel_launches": counts}), flush=True)
    cs.print_phases()
    return 0


if __name__ == "__main__":
    sys.exit(main())
