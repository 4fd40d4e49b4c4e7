"""MiniROAD-Anticipation variant (port of prego_tpu/models/miniroad_a.py).

Parity surface: MROADA (step_recognition/model/rnn/rnn.py:73-137),
registered "MiniROADA". It adds to MiniROAD an anticipation head: a linear
layer that expands each hidden state into ``anticipation_length`` future
hidden states, classified by the SAME classifier head; with
``actionness`` also a one-unit actionness head, which holds parameters
only (the reference's forward never reads it). The GRU runs through
MiniROAD's dispatch: K1 in eval and K1 + K6 in training on a CUDA tensor.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from prego_tpu_torch.core.registry import MODELS
from prego_tpu_torch.models.miniroad import MiniROAD, Params, _linear_init
from prego_tpu_torch.ops.dense import mm_f32


@MODELS.register("MiniROADA")
class MiniROADA(MiniROAD):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.anticipation_length = cfg["anticipation_length"]
        self.actionness = cfg.get("actionness", False)

    def init(self, generator: torch.Generator, dtype=torch.float32, device="cpu") -> Params:
        params = super().init(generator, dtype, device)
        H, L = self.hidden_dim, self.anticipation_length
        params["anticipation"] = _linear_init(H, L * H, generator, dtype, device)
        if self.actionness:
            params["actionness"] = _linear_init(H, 1, generator, dtype, device)
        return params

    def _heads(self, params: Params, ht: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """ht (B, S, H) raw GRU states -> (logits (B, S, K), anticipation
        logits (B, S, L, K)), as rnn.py:123-126: the classifier on relu(ht);
        the anticipation layer on relu(ht), reshaped to (B, S, L, H), then
        the classifier on relu of that."""
        B, S, _ = ht.shape
        relu_ht = torch.relu(ht)
        cls_w, cls_b = params["cls"]["w"], params["cls"]["b"]
        logits = mm_f32(relu_ht, cls_w) + cls_b
        ant_h = (mm_f32(relu_ht, params["anticipation"]["w"]) + params["anticipation"]["b"])
        ant_h = ant_h.reshape(B, S, self.anticipation_length, self.hidden_dim)
        return logits, mm_f32(torch.relu(ant_h), cls_w) + cls_b

    def forward_train(
        self, params: Params, rgb: torch.Tensor, flow: Optional[torch.Tensor],
        generator: Optional[torch.Generator], flow_is_zero: bool = False,
        backend: str = "scan",
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(last-frame logits (B, K), last-frame anticipation logits (B, L,
        K)): the ANTICIPATION loss reads only the last frame
        (criterions/loss.py:51-55)."""
        if generator is None and self.dropout > 0.0:
            raise ValueError("forward_train: dropout needs a generator")
        x = self._embed(params, rgb, flow, flow_is_zero=flow_is_zero, generator=generator)
        ht = self._run_gru_train(params, x, backend)
        logits, ant_logits = self._heads(params, ht[:, -1:, :])
        return logits[:, 0], ant_logits[:, 0]

    def forward_full(
        self, params: Params, rgb: torch.Tensor, flow: Optional[torch.Tensor],
        flow_is_zero: bool = False, softmax: bool = True, backend: str = "scan",
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scores (B, T, K), anticipation scores (B, T, L, K))."""
        x = self._embed(params, rgb, flow, flow_is_zero=flow_is_zero)
        logits, ant_logits = self._heads(params, self._run_gru(params, x, backend=backend))
        if softmax:
            return torch.softmax(logits, dim=-1), torch.softmax(ant_logits, dim=-1)
        return logits, ant_logits
