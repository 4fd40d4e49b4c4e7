"""GRU recurrence, plain PyTorch (the oracle of the K1 kernel).

Port of prego_tpu/ops/gru.py:50-86. Gate order and math match
torch.nn.GRU (r, z, n); weights are stored (E, 3H) / (H, 3H) for
right-multiplication, and the input projection x.W_ih + b_ih is hoisted
out of the recurrence as one product over all frames:

  r = sigmoid(xg_r + h W_hr + b_hr)
  z = sigmoid(xg_z + h W_hz + b_hz)
  n = tanh(xg_n + r * (h W_hn + b_hn))
  h' = (1 - z) * n + z * h
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from prego_tpu_torch.ops.dense import mm_f32


def init_gru_params(
    input_dim: int, hidden_dim: int, generator: torch.Generator,
    dtype=torch.float32, device="cpu",
) -> Dict[str, torch.Tensor]:
    """torch.nn.GRU default init: U(-k, k), k = 1/sqrt(hidden_dim)."""
    k = 1.0 / hidden_dim ** 0.5

    def u(*shape):
        r = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
        return ((r * 2 - 1) * k).to(dtype)

    return {
        "w_ih": u(input_dim, 3 * hidden_dim),
        "b_ih": u(3 * hidden_dim),
        "w_hh": u(hidden_dim, 3 * hidden_dim),
        "b_hh": u(3 * hidden_dim),
    }


def gru_cell(
    xg: torch.Tensor, h: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> torch.Tensor:
    """One step given precomputed input gates xg (..., 3H); h (..., H)."""
    H = h.shape[-1]
    hg = mm_f32(h, w_hh) + b_hh
    xr, xz, xn = xg[..., :H], xg[..., H : 2 * H], xg[..., 2 * H :]
    hr, hz, hn = hg[..., :H], hg[..., H : 2 * H], hg[..., 2 * H :]
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return ((1.0 - z) * n + z * h).to(h.dtype)


def gru_scan(
    x: torch.Tensor, h0: torch.Tensor, params: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, E), h0 (B, H) -> (hs (B, T, H), hT (B, H))."""
    xg = (mm_f32(x, params["w_ih"]) + params["b_ih"]).to(x.dtype)
    h = h0
    hs = []
    for t in range(x.shape[1]):
        h = gru_cell(xg[:, t], h, params["w_hh"], params["b_hh"])
        hs.append(h)
    if not hs:
        return x.new_zeros(x.shape[0], 0, h0.shape[-1]), h0
    return torch.stack(hs, dim=1), h
