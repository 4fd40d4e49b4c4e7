"""Transformer (ViT-encoder) online recognizer (port of
prego_tpu/models/transformer.py).

Parity surface: the reference's registered "Transformer" model (ViTEnc,
step_recognition/model/transformer_models/ViT.py:25-160). Kept from the
JAX package, which keeps them from the reference bug for bug (they define
the checkpoint contract):

  * per-frame features linearly embedded (ViT.py:58,124), a zeros-initialized
    learnable CLS token APPENDED at the end (ViT.py:131), learned positional
    embeddings added (PositionalEncoding.py:26-41), then a pre-LN encoder
    stack: x + drop(attn(LN(x))) and x + mlp(LN(x)) (Transformer.py:49-82),
    attention with NO qkv bias and scale hd^-0.5 (Attention.py:7-41), an
    exact-erf GELU MLP, a final LayerNorm (ViT.py:79), and the classifier
    reads token 0, which with the CLS token at the END is the FIRST FRAME's
    token (ViT.py:138);
  * dropout placement: the positional-embedding dropout, the block-output
    dropout and both MLP dropouts at cfg.dropout; the attention-prob and
    attention-projection dropouts at cfg.attn_dropout_rate
    (Transformer.py:23-46, Attention.py:17-19,40). Every mask is drawn from
    the caller's ``torch.Generator``, in the order the JAX package splits
    its key;
  * ``flatten_dim = patch_dim x channels`` with a real patch reshape (the
    reference's ``patch_dim² x C`` crashes for patch_dim > 1; PARITY.md);
  * a zero flow stream is concatenated, not skipped.

The attention is plain f32 matrix products, as the JAX einsums are (no
TPU kernel computes it). Full-video eval classifies every frame t from
the window ending at t (zero-padded at the start, as the training zero
prefix), the windows built in chunks of 64 frames so memory is constant
in video length.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from prego_tpu_torch.core.registry import MODELS
from prego_tpu_torch.data.features import FEATURE_SIZES
from prego_tpu_torch.models.miniroad import _linear_init
from prego_tpu_torch.ops.dense import mm_f32

Params = Dict[str, Any]


def _dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout: a kept unit is scaled by 1 / keep."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _ln(x: torch.Tensor, p) -> torch.Tensor:
    """LayerNorm (torch eps=1e-5), written out as the JAX version is."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]


@MODELS.register("Transformer")
class TransformerRecognizer:
    """Stateless module: params live outside, methods are pure functions.
    It has no ``init_hidden``: the evaluator scores it by windows."""

    def __init__(self, cfg):
        self.use_rgb = not cfg["no_rgb"]
        self.use_flow = not cfg["no_flow"]
        self.rgb_dim = FEATURE_SIZES[cfg["rgb_type"]] if self.use_rgb else 0
        self.flow_dim = FEATURE_SIZES[cfg["flow_type"]] if self.use_flow else 0
        self.input_dim = self.rgb_dim + self.flow_dim
        self.window_size = cfg["window_size"]
        self.patch_dim = cfg.get("patch_dim", 1)
        if self.window_size % self.patch_dim:
            raise ValueError(f"window_size {self.window_size} is no multiple of patch_dim "
                             f"{self.patch_dim}")
        self.num_patches = self.window_size // self.patch_dim
        self.embedding_dim = cfg["embedding_dim"]
        self.num_heads = cfg.get("num_heads", 8)
        if self.embedding_dim % self.num_heads:
            raise ValueError(f"embedding_dim {self.embedding_dim} is no multiple of num_heads "
                             f"{self.num_heads}")
        self.num_layers = cfg["num_layers"]
        self.hidden_dim = cfg["hidden_dim"]  # the MLP width
        self.num_classes = cfg["num_classes"]
        self.dropout = cfg["dropout"]
        self.attn_dropout = cfg.get("attn_dropout_rate", 0.0)
        self.flatten_dim = self.patch_dim * self.input_dim

    # ---- parameters ----

    def init(self, generator: torch.Generator, dtype=torch.float32, device="cpu") -> Params:
        E = self.embedding_dim

        def ln():
            return {"scale": torch.ones(E, dtype=dtype, device=device),
                    "bias": torch.zeros(E, dtype=dtype, device=device)}

        pos = torch.randn((self.num_patches + 1, E), generator=generator, device=device)
        params: Params = {
            "embed": _linear_init(self.flatten_dim, E, generator, dtype, device),
            "cls_token": torch.zeros((1, 1, E), dtype=dtype, device=device),  # ViT.py:56
            "pos": (pos * 0.02).to(dtype),
            "head": _linear_init(E, self.num_classes, generator, dtype, device),
            "ln_f": ln(),
            "blocks": [],
        }
        for _ in range(self.num_layers):
            qkv = _linear_init(E, 3 * E, generator, dtype, device)
            del qkv["b"]  # qkv_bias=False (Attention.py:16)
            params["blocks"].append({
                "ln1": ln(), "qkv": qkv,
                "proj": _linear_init(E, E, generator, dtype, device),
                "ln2": ln(),
                "mlp_in": _linear_init(E, self.hidden_dim, generator, dtype, device),
                "mlp_out": _linear_init(self.hidden_dim, E, generator, dtype, device),
            })
        return params

    # ---- blocks ----

    def _encoder(self, params: Params, x: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        """tokens (B, S, E) -> (B, S, E): pre-LN attention + GELU MLP blocks;
        dropout only with a ``generator``."""
        B, S, E = x.shape
        H = self.num_heads
        hd = E // H
        train = generator is not None
        for blk in params["blocks"]:
            qkv = mm_f32(_ln(x, blk["ln1"]), blk["qkv"]["w"]).reshape(B, S, 3, H, hd)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B, H, S, hd)
            scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            if train:
                probs = _dropout(probs, self.attn_dropout, generator)
            attn = torch.matmul(probs.float(), v.float()).transpose(1, 2).reshape(B, S, E)
            out = (mm_f32(attn.to(x.dtype), blk["proj"]["w"]) + blk["proj"]["b"]).to(x.dtype)
            if train:
                out = _dropout(out, self.attn_dropout, generator)  # proj_drop
                out = _dropout(out, self.dropout, generator)  # PreNormDrop
            x = x + out
            h = torch.nn.functional.gelu(
                mm_f32(_ln(x, blk["ln2"]), blk["mlp_in"]["w"]) + blk["mlp_in"]["b"]
            )  # exact erf, as torch nn.GELU (Transformer.py:40)
            if train:
                h = _dropout(h, self.dropout, generator)
            out = (mm_f32(h, blk["mlp_out"]["w"]) + blk["mlp_out"]["b"]).to(x.dtype)
            if train:
                out = _dropout(out, self.dropout, generator)
            x = x + out
        return _ln(x, params["ln_f"])

    def _window_logits(self, params: Params, windows: torch.Tensor,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
        """windows (B, W, D_in) -> (B, K) logits from token 0 (the first frame)."""
        B = windows.shape[0]
        patches = windows.reshape(B, self.num_patches, self.flatten_dim)
        emb = (mm_f32(patches, params["embed"]["w"]) + params["embed"]["b"]).to(windows.dtype)
        cls = params["cls_token"].expand(B, 1, self.embedding_dim).to(emb.dtype)
        # the CLS token appended LAST (ViT.py:131); the readout is token 0 (ViT.py:138)
        tokens = torch.cat([emb, cls], dim=1) + params["pos"][None]
        if generator is not None:
            tokens = _dropout(tokens, self.dropout, generator)  # pe_dropout
        enc = self._encoder(params, tokens, generator)
        return mm_f32(enc[:, 0], params["head"]["w"]) + params["head"]["b"]

    def _concat(self, rgb: torch.Tensor, flow: Optional[torch.Tensor], flow_is_zero: bool):
        """The model's input: rgb and flow side by side, a zero flow
        stream made here and concatenated (``flow`` may then be None)."""
        if self.use_rgb and self.use_flow:
            if flow_is_zero or flow is None:
                flow = rgb.new_zeros((*rgb.shape[:-1], self.flow_dim))
            return torch.cat([rgb, flow.to(rgb.dtype)], dim=-1)
        return rgb if self.use_rgb else flow

    # ---- public forwards (MiniROAD's surface) ----

    def forward_train(
        self, params: Params, rgb: torch.Tensor, flow: Optional[torch.Tensor],
        generator: Optional[torch.Generator], flow_is_zero: bool = False, backend=None,
    ) -> torch.Tensor:
        """Training windows (B, W, D) -> logits (B, K). Dropout draws from
        ``generator``, which only zero dropout rates may omit. ``backend``
        (the GRU's) is ignored."""
        if generator is None and (self.dropout > 0.0 or self.attn_dropout > 0.0):
            raise ValueError("forward_train: dropout needs a generator")
        return self._window_logits(params, self._concat(rgb, flow, flow_is_zero), generator)

    @torch.no_grad()
    def forward_full(
        self, params: Params, rgb: torch.Tensor, flow: Optional[torch.Tensor],
        flow_is_zero: bool = False, softmax: bool = True, backend=None, frame_chunk: int = 64,
    ) -> torch.Tensor:
        """Per-frame causal scores for full sequences (B, T, D) -> (B, T, K):
        frame t is classified from the window [t-W+1, t], zero-padded at
        the start; the windows are built ``frame_chunk`` frames at a time."""
        x = self._concat(rgb, flow, flow_is_zero)
        B, T, D = x.shape
        W = self.window_size
        pad = torch.cat([x.new_zeros((B, W - 1, D)), x], dim=1)
        offsets = torch.arange(W, device=x.device)
        outs = []
        for t0 in range(0, T, frame_chunk):
            n = min(frame_chunk, T - t0)
            # the windows of frames t0..t0+n-1: rows [t, t+W) of the padded sequence
            idx = (t0 + torch.arange(n, device=x.device))[:, None] + offsets[None, :]
            wins = pad[:, idx]  # (B, n, W, D)
            logits = self._window_logits(params, wins.reshape(B * n, W, D), None)
            outs.append(logits.reshape(B, n, self.num_classes))
        logits = torch.cat(outs, dim=1)
        return torch.softmax(logits, dim=-1) if softmax else logits
