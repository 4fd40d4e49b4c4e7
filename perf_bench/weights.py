"""Weights drawn from the seed on the device, in the type they are served
in, in a few large calls: one buffer a group of projections that share
their input width, each projection a contiguous piece of it.

The trees are the port's serving layout (``wqkv`` = wq | wk | wv and
``w13`` = w1 | w3 along the output width, (in, out) matrices), which the
plain references read as given.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _carve(buf: torch.Tensor, shapes: List[tuple]) -> List[torch.Tensor]:
    out, o = [], 0
    for shape in shapes:
        n = 1
        for d in shape:
            n *= d
        out.append(buf[o:o + n].view(*shape))
        o += n
    return out


def _normal(n: int, std: float, g: torch.Generator, device, dtype) -> torch.Tensor:
    """n draws of N(0, std^2), filled in pieces of 2^30 (a fill of more than
    2^31 elements is not every kernel's)."""
    out = torch.empty(n, device=device, dtype=dtype)
    for o in range(0, n, 1 << 30):
        out[o:o + (1 << 30)].normal_(0.0, std, generator=g)
    return out


def llama_tree(c: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """A random LLaMA-family tree: every matrix N(0, 1/d_in), norms 1."""
    g = _generator(seed, device)
    D, L, V, F = c["dim"], c["n_layers"], c["vocab_size"], c["ffn_hidden"]
    q = (c["n_heads"] + 2 * c["n_kv_heads"]) * c["head_dim"]
    o = c["n_heads"] * c["head_dim"]
    by_d = [(D, q), (o, D), (D, 2 * F)] * L + [(D, V)]  # wo's width o equals D here
    by_f = [(F, D)] * L
    n_d = sum(a * b for a, b in by_d)
    a = _normal(n_d, D ** -0.5, g, device, dtype)
    b = _normal(L * F * D, F ** -0.5, g, device, dtype)
    emb = _normal(V * D, D ** -0.5, g, device, dtype).view(V, D)
    pieces = _carve(a, by_d)
    w2s = _carve(b, by_f)
    ones = torch.ones(2 * L + 1, D, device=device, dtype=dtype)
    layers = []
    for i in range(L):
        wqkv, wo, w13 = pieces[3 * i:3 * i + 3]
        layers.append({"attention": {"wqkv": wqkv, "wo": wo},
                       "feed_forward": {"w13": w13, "w2": w2s[i]},
                       "attention_norm": ones[2 * i], "ffn_norm": ones[2 * i + 1]})
    return {"tok_embeddings": emb, "layers": layers, "norm": ones[2 * L], "output": pieces[-1]}


def miniroad_tree(c: Dict, seed: int, device) -> Dict:
    """A MiniROAD tree as ``torch.nn`` initializes one (Linear and GRU
    uniform in +-1/sqrt(fan), LayerNorm 1 and 0), in f32, drawn in one
    call: ``embed`` (rgb + flow, E), ``ln``, ``gru`` layers and ``cls``."""
    g = _generator(seed, device)
    din = c["rgb_dim"] + c["flow_dim"]
    E, H, K = c["embedding_dim"], c["hidden_dim"], c["num_classes"]
    shapes, scales = [(din, E), (E,)], [din ** -0.5] * 2
    d_in = E
    for _ in range(c["num_layers"]):
        shapes += [(d_in, 3 * H), (3 * H,), (H, 3 * H), (3 * H,)]
        scales += [H ** -0.5] * 4
        d_in = H
    shapes += [(H, K), (K,)]
    scales += [H ** -0.5] * 2
    n = sum(int(torch.tensor(s).prod()) for s in shapes)
    u = torch.rand(n, generator=g, device=device, dtype=torch.float32).mul_(2).sub_(1)
    leaves = _carve(u, shapes)
    for leaf, k in zip(leaves, scales):
        leaf.mul_(k)
    leaves = [leaf.clone() for leaf in leaves]  # each leaf its own storage, as the optimizer wants
    tree = {"embed": {"w": leaves[0], "b": leaves[1]},
            "ln": {"scale": torch.ones(E, device=device), "bias": torch.zeros(E, device=device)},
            "gru": [], "cls": {"w": leaves[-2], "b": leaves[-1]}}
    for i in range(c["num_layers"]):
        w_ih, b_ih, w_hh, b_hh = leaves[2 + 4 * i:6 + 4 * i]
        tree["gru"].append({"w_ih": w_ih, "b_ih": b_ih, "w_hh": w_hh, "b_hh": b_hh})
    return tree


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in key order (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]

