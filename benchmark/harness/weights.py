"""Seeded weights, made on the device, one large draw a tensor.

The benchmark makes the weights and hands the same values to the program
and to the plain reference. The tree is a dict under the names the port's
Llama-style models read (``tok_embed``, ``lm_head``, ``final_norm`` and the
layer stacks under ``layers``, each with a leading layer axis). Each leaf
has its own generator, seeded from the run's seed and the leaf's index, so
any leaf can be drawn again alone (the reference draws them again after
the program is freed). Matmul weights are normal draws over
``sqrt(fan_in)``, the embedding's scaled by 0.02, norm weights
``1 + 0.1 * normal`` (not all ones, so a norm that drops its weight
shows).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.harness.counts import dims
from benchmark.harness.traffic import mix_seed

NORMS = ("attn_norm", "mlp_norm", "final_norm")


def leaves(cfg) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(path, shape, scale) of every leaf, in draw order. ``scale`` 0
    marks a norm weight."""
    m = dims(cfg)
    L, E, H, KV, D, M, V = (m[k] for k in "L E H KV D M V".split())
    return [
        ("tok_embed", (V, E), 0.02),
        ("layers/attn_norm", (L, E), 0.0),
        ("layers/wq", (L, E, H, D), E ** -0.5),
        ("layers/wk", (L, E, KV, D), E ** -0.5),
        ("layers/wv", (L, E, KV, D), E ** -0.5),
        ("layers/wo", (L, H, D, E), (H * D) ** -0.5),
        ("layers/mlp_norm", (L, E), 0.0),
        ("layers/w_gate", (L, E, M), E ** -0.5),
        ("layers/w_up", (L, E, M), E ** -0.5),
        ("layers/w_down", (L, M, E), M ** -0.5),
        ("final_norm", (E,), 0.0),
        ("lm_head", (E, V), E ** -0.5),
    ]


def draw(cfg, seed: int, path: str, dtype: torch.dtype,
         device) -> torch.Tensor:
    """Leaf ``path``: matmul weights in ``dtype``, norm weights in fp32."""
    for i, (name, shape, scale) in enumerate(leaves(cfg)):
        if name != path:
            continue
        g = torch.Generator(device=device)
        g.manual_seed(mix_seed(seed, 7, i))
        if scale == 0.0:
            w = torch.randn(shape, generator=g, device=device,
                            dtype=torch.float32)
            return w.mul_(0.1).add_(1.0)
        w = torch.randn(shape, generator=g, device=device, dtype=dtype)
        return w.mul_(scale)
    raise KeyError(path)


def make(cfg, seed: int, dtype: torch.dtype, device) -> Dict:
    """The whole tree (see the module docstring)."""
    tree: Dict = {"layers": {}}
    for path, _, _ in leaves(cfg):
        t = draw(cfg, seed, path, dtype, device)
        if path.startswith("layers/"):
            tree["layers"][path.split("/", 1)[1]] = t
        else:
            tree[path] = t
    return tree


def flat(tree: Dict) -> Dict[str, torch.Tensor]:
    """The leaves of a tree by path."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    out.update({f"layers/{k}": v for k, v in tree["layers"].items()})
    return out
