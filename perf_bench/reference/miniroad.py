"""A plain MiniROAD train step (MiniROAD, ICCV 2023, as PREGO trains it:
step_recognition/model/rnn/rnn.py, criterions/loss.py, main.py) in float32
with TF32 off, its gradients by autograd, and torch's AdamW update:

  x      = Dropout(ReLU(LayerNorm(rgb W_e[:D_rgb] + b_e)))   (flow is zero)
  r, z   = sigmoid(x W_ir + b_ir + h W_hr + b_hr), ... (z likewise)
  n      = tanh(x W_in + b_in + r (h W_hn + b_hn))
  h'     = (1 - z) n + z h                                    (torch.nn.GRU)
  logits = ReLU(h_T) W_c + b_c                                (the last frame)
  loss   = mean over valid rows of -sum(t / |t| * log_softmax(logits))

The windows of the first batches are worked out again from the seed as the
reference sampler draws them (dataset.py:113-119: a random offset a video
each epoch, strided windows, ``window - 1`` zero frames before each
video, the order shuffled), read from the raw feature files. The dropout
mask is drawn from a generator seeded as the trainer's is, with the same
calls in the same order. ``dtype`` other than float32 is the control.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def first_batches(root: str, rgb_type: str, vids: Sequence[str], window: int, stride: int,
                  batch: int, n: int, seed: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The first ``n`` batches (rgb (B, W, D), last-frame target (B, K)) of
    an epoch whose offsets and order come from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    feats = [np.load(os.path.join(root, rgb_type, v + ".npy"), mmap_mode="r") for v in vids]
    tgts = [np.load(os.path.join(root, "target_perframe", v + ".npy"), mmap_mode="r")
            for v in vids]
    wins = []
    for vi, f in enumerate(feats):
        T = len(f) + window - 1
        start = int(rng.integers(0, stride))
        while start + window <= T:
            wins.append((vi, start))
            start += stride
    order = np.arange(len(wins))
    rng.shuffle(order)
    out = []
    for b in range(n):
        rgb, tgt = [], []
        for k in order[b * batch:(b + 1) * batch]:
            vi, s = wins[k]
            lo, hi = s - (window - 1), s + 1  # the window in video frames
            f = np.asarray(feats[vi][max(lo, 0):hi], np.float32)
            rgb.append(np.concatenate([np.zeros((window - len(f), f.shape[1]), np.float32), f]))
            tgt.append(np.asarray(tgts[vi][hi - 1], np.float32))
        out.append((np.stack(rgb), np.stack(tgt)))
    return out


def forward_loss(p: Dict[str, torch.Tensor], rgb: torch.Tensor, target: torch.Tensor,
                 mask: torch.Tensor, keep: float, rgb_dim: int,
                 rows: Optional[int] = None) -> torch.Tensor:
    """The masked mean loss of a full batch; ``rows`` keeps only the first
    rows (the fault of a batch half left out)."""
    dt = p["gru.w_hh"].dtype
    x = rgb.to(dt) @ p["embed.w"][:rgb_dim] + p["embed.b"]
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + 1e-5) * p["ln.scale"] + p["ln.bias"]
    x = torch.where(mask, torch.relu(x) / keep, torch.zeros_like(x))
    H = p["gru.w_hh"].shape[0]
    xg = x @ p["gru.w_ih"] + p["gru.b_ih"]
    h = torch.zeros(x.shape[0], H, dtype=dt, device=x.device)
    for t in range(x.shape[1]):
        hg = h @ p["gru.w_hh"] + p["gru.b_hh"]
        r = torch.sigmoid(xg[:, t, :H] + hg[:, :H])
        z = torch.sigmoid(xg[:, t, H:2 * H] + hg[:, H:2 * H])
        n = torch.tanh(xg[:, t, 2 * H:] + r * hg[:, 2 * H:])
        h = (1 - z) * n + z * h
    logits = torch.relu(h) @ p["cls.w"] + p["cls.b"]
    t = target.to(dt)
    t = t / torch.clamp(t.norm(dim=-1, keepdim=True), min=1e-12)
    per_row = -(t * torch.log_softmax(logits.float(), dim=-1).to(dt)).sum(-1)
    return per_row[:rows].mean()


def flat(tree) -> Dict[str, torch.Tensor]:
    """{"embed.w": ..., "gru.w_ih": ..., ...} of a one-layer MiniROAD tree."""
    g = tree["gru"][0]
    return {"embed.w": tree["embed"]["w"], "embed.b": tree["embed"]["b"],
            "ln.scale": tree["ln"]["scale"], "ln.bias": tree["ln"]["bias"],
            "gru.w_ih": g["w_ih"], "gru.b_ih": g["b_ih"], "gru.w_hh": g["w_hh"],
            "gru.b_hh": g["b_hh"], "cls.w": tree["cls"]["w"], "cls.b": tree["cls"]["b"]}


def train(p0: Dict[str, torch.Tensor], batches, dropout_seed: int, keep: float, lr: float,
          weight_decay: float, rgb_dim: int, dtype=torch.float32,
          betas=(0.9, 0.999), eps=1e-8, rows: Optional[int] = None) -> Dict:
    """Steps of AdamW from ``p0`` over ``batches``: the losses, the first
    step's gradients, and the parameters after the last step. ``dtype``
    other than float32 computes everything in it (the control); ``rows``
    is ``forward_loss``'s."""
    dev = next(iter(p0.values())).device
    p = {k: v.detach().to(dtype).clone().requires_grad_(True) for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    g = torch.Generator(device=dev)
    g.manual_seed(dropout_seed)
    E = p["embed.w"].shape[1]
    losses, first_grad = [], None
    for step, (rgb, tgt) in enumerate(batches, start=1):
        rgb_t = torch.as_tensor(rgb, device=dev)
        mask = torch.rand((rgb.shape[0], rgb.shape[1], E), generator=g, device=dev) < keep
        loss = forward_loss(p, rgb_t, torch.as_tensor(tgt, device=dev), mask, keep, rgb_dim, rows)
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = {k: gr.detach().float().clone() for k, gr in zip(p, grads)}
        with torch.no_grad():
            b1, b2 = betas
            for (k, w), gr in zip(p.items(), grads):
                w.mul_(1 - lr * weight_decay)
                m[k].mul_(b1).add_(gr, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(gr, gr, value=1 - b2)
                denom = (v2[k].sqrt() / (1 - b2 ** step) ** 0.5).add_(eps)
                w.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** step))
    return {"losses": losses, "grad": first_grad,
            "params": {k: w.detach().float() for k, w in p.items()}}


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keep_leaf=None) -> Tuple[float, str]:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's."""
    norms = {k: float(ref[k].norm()) for k in ref if keep_leaf is None or keep_leaf(k)}
    med = float(np.median(list(norms.values())))
    worst, at = 0.0, ""
    for k, nr in norms.items():
        gap = abs(float(prog[k].float().norm()) - nr) / max(nr, med, 1e-30)
        if gap > worst:
            worst, at = gap, k
    return worst, at


def compare(side: Dict, r: Dict, p0: Dict[str, torch.Tensor]) -> Tuple[Dict[str, float], Dict]:
    """The numbers compared between a side (the program's, or a control's:
    ``losses`` of three steps, the first ``grad``, ``params`` after three)
    and the float32 reference ``r``: each step's loss, relative; the first
    gradient and the change over three steps by the worst leaf. Leaves
    whose reference gradient is under a thousandth of the median leaf's
    move by round-off alone and are left out of the change. Returns the
    numbers and where each was worst."""
    out = {}
    for k in range(3):
        lp, lr_ = side["losses"][k], r["losses"][k]
        out[f"loss_step{k + 1}"] = abs(lp - lr_) / max(abs(lr_), 1e-30)
    out["first_grad"], g_at = leaf_gap(side["grad"], r["grad"])
    gnorm = {k: float(v.norm()) for k, v in r["grad"].items()}
    med = float(np.median(list(gnorm.values())))
    moved = {k for k in gnorm if gnorm[k] >= 1e-3 * med}
    d_side = {k: side["params"][k].float() - p0[k].float() for k in p0}
    d_ref = {k: r["params"][k] - p0[k].float() for k in p0}
    out["change3"], c_at = leaf_gap(d_side, d_ref, lambda k: k in moved)
    return out, {"first_grad_leaf": g_at, "change3_leaf": c_at,
                 "excluded": sorted(set(gnorm) - moved)}


@torch.no_grad()
def stream_ids(p: Dict[str, torch.Tensor], rgb: torch.Tensor, h: torch.Tensor,
               rgb_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Strictly causal recognition of a block of frames (N, B, D) from the
    states ``h`` (B, H): each frame's class (the argmax of the logits,
    the first on ties) and the states after the block. No dropout."""
    dt = p["gru.w_hh"].dtype
    H = p["gru.w_hh"].shape[0]
    x = rgb.to(dt) @ p["embed.w"][:rgb_dim] + p["embed.b"]
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    x = torch.relu((x - mu) * torch.rsqrt(var + 1e-5) * p["ln.scale"] + p["ln.bias"])
    xg = x @ p["gru.w_ih"] + p["gru.b_ih"]
    ids = []
    for t in range(rgb.shape[0]):
        hg = h @ p["gru.w_hh"] + p["gru.b_hh"]
        r = torch.sigmoid(xg[t, :, :H] + hg[:, :H])
        z = torch.sigmoid(xg[t, :, H:2 * H] + hg[:, H:2 * H])
        n = torch.tanh(xg[t, :, 2 * H:] + r * hg[:, 2 * H:])
        h = (1 - z) * n + z * h
        ids.append((torch.relu(h) @ p["cls.w"] + p["cls.b"]).argmax(-1))
    return torch.stack(ids), h
