"""MiniROAD streaming step-recognition model (port of
prego_tpu/models/miniroad.py).

Parity surface: MROAD (step_recognition/model/rnn/rnn.py:18-71):

  input  = concat(rgb, flow) along features        (rnn.py:52-58)
  embed  = Dropout(ReLU(LayerNorm(Linear(Din->E)))) (rnn.py:39-44)
  gru    = GRU(E -> H, num_layers, zero h0)         (rnn.py:38,47-49,63)
  logits = Linear(ReLU(h) -> K)                     (rnn.py:45-46,64-67)

As in the JAX package the model is stateless: parameters are a dict of
tensors with the JAX pytree's keys and (in, out) layout, so checkpoints
and parity tests cross over through ``checkpoint/bridge.py``. When the
flow stream is structurally zero (``flow_is_zero``) the dead half of the
embed product is skipped. Eval only: dropout is not applied.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from prego_tpu.data.features import FEATURE_SIZES
from prego_tpu_torch.core.registry import MODELS
from prego_tpu_torch.ops.dense import mm_f32
from prego_tpu_torch.ops.gru import gru_cell, gru_scan, init_gru_params
from prego_tpu_torch.ops.gru_cuda import gru_layer

Params = Dict[str, Any]


def _linear_init(d_in: int, d_out: int, generator, dtype, device):
    """torch.nn.Linear default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    k = 1.0 / d_in ** 0.5

    def u(*shape):
        r = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
        return ((r * 2 - 1) * k).to(dtype)

    return {"w": u(d_in, d_out), "b": u(d_out)}


@MODELS.register("MiniROAD")
class MiniROAD:
    """Stateless module: params live outside, methods are pure functions."""

    def __init__(self, cfg):
        self.use_rgb = not cfg["no_rgb"]
        self.use_flow = not cfg["no_flow"]
        self.rgb_dim = FEATURE_SIZES[cfg["rgb_type"]] if self.use_rgb else 0
        self.flow_dim = FEATURE_SIZES[cfg["flow_type"]] if self.use_flow else 0
        self.input_dim = self.rgb_dim + self.flow_dim
        self.embedding_dim = cfg["embedding_dim"]
        self.hidden_dim = cfg["hidden_dim"]
        self.num_layers = cfg["num_layers"]
        self.num_classes = cfg["num_classes"]
        self.dropout = cfg["dropout"]

    # ---- parameters ----

    def init(self, generator: torch.Generator, dtype=torch.float32, device="cpu") -> Params:
        params: Params = {
            "embed": _linear_init(self.input_dim, self.embedding_dim, generator, dtype, device),
            "ln": {
                "scale": torch.ones(self.embedding_dim, dtype=dtype, device=device),
                "bias": torch.zeros(self.embedding_dim, dtype=dtype, device=device),
            },
            "cls": _linear_init(self.hidden_dim, self.num_classes, generator, dtype, device),
            "gru": [],
        }
        in_dim = self.embedding_dim
        for _ in range(self.num_layers):
            params["gru"].append(
                init_gru_params(in_dim, self.hidden_dim, generator, dtype, device)
            )
            in_dim = self.hidden_dim
        return params

    # ---- building blocks ----

    def _embed(
        self, params: Params, rgb: torch.Tensor, flow: Optional[torch.Tensor], *,
        flow_is_zero: bool,
    ) -> torch.Tensor:
        w, b = params["embed"]["w"], params["embed"]["b"]
        if self.use_rgb and self.use_flow:
            if flow_is_zero:
                # concat(rgb, 0) @ W == rgb @ W[:rgb_dim] (dataset.py:63-69)
                x = mm_f32(rgb, w[: self.rgb_dim]) + b
            else:
                x = mm_f32(rgb, w[: self.rgb_dim]) + mm_f32(flow, w[self.rgb_dim :]) + b
        elif self.use_rgb:
            x = mm_f32(rgb, w) + b
        else:
            x = mm_f32(flow, w) + b
        # LayerNorm (torch eps=1e-5), written out to mirror the JAX version
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        x = (x - mu) * torch.rsqrt(var + 1e-5)
        x = x * params["ln"]["scale"] + params["ln"]["bias"]
        return torch.relu(x).to(rgb.dtype)

    def _run_gru(self, params: Params, x: torch.Tensor, backend: str = "scan") -> torch.Tensor:
        """backend 'kernel' streams bf16 through the K1 wrapper (the kernel
        on the card, its plain version on the CPU); 'scan' is the f32
        reference recurrence. A CUDA tensor always takes the kernel."""
        B = x.shape[0]
        h = x
        for layer_params in params["gru"]:
            h0 = torch.zeros(B, self.hidden_dim, dtype=x.dtype, device=x.device)
            if backend == "kernel" or x.is_cuda:
                h, _ = gru_layer(h, h0, layer_params, stream_dtype=torch.bfloat16)
            else:
                h, _ = gru_scan(h, h0, layer_params)
        return h

    def _classify(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        return mm_f32(torch.relu(h), params["cls"]["w"]) + params["cls"]["b"]

    # ---- public forwards ----

    def forward_full(
        self, params: Params, rgb: torch.Tensor, flow: Optional[torch.Tensor],
        flow_is_zero: bool = False, softmax: bool = True, backend: str = "scan",
    ) -> torch.Tensor:
        """Eval forward on full (padded) sequences -> (B, T, K) scores."""
        x = self._embed(params, rgb, flow, flow_is_zero=flow_is_zero)
        h = self._run_gru(params, x, backend=backend)
        logits = self._classify(params, h)
        return torch.softmax(logits, dim=-1) if softmax else logits

    def forward_step(
        self, params: Params, rgb_t: torch.Tensor, flow_t: Optional[torch.Tensor],
        hidden: Tuple[torch.Tensor, ...], flow_is_zero: bool = False,
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """Strictly-causal single-frame step: rgb_t (B, D_rgb), hidden a
        per-layer (B, H) state -> (softmax scores (B, K), new hidden)."""
        x = self._embed(
            params, rgb_t[:, None, :], None if flow_t is None else flow_t[:, None, :],
            flow_is_zero=flow_is_zero,
        )[:, 0, :]
        new_hidden = []
        h_in = x
        for layer_params, h_prev in zip(params["gru"], hidden):
            xg = mm_f32(h_in, layer_params["w_ih"]) + layer_params["b_ih"]
            h_new = gru_cell(xg.to(h_prev.dtype), h_prev, layer_params["w_hh"], layer_params["b_hh"])
            new_hidden.append(h_new)
            h_in = h_new
        logits = self._classify(params, h_in)
        return torch.softmax(logits, dim=-1), tuple(new_hidden)

    def init_hidden(self, batch: int, dtype=torch.float32, device="cpu") -> Tuple[torch.Tensor, ...]:
        return tuple(
            torch.zeros(batch, self.hidden_dim, dtype=dtype, device=device)
            for _ in range(self.num_layers)
        )
