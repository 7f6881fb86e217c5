"""A plain Llama-style decoder in float32: RMSNorm, rotary embeddings
(rotate-half, ``theta = rope_theta``), grouped-query causal attention,
SwiGLU, an untied LM head. It follows the published description of the
Mistral and InternLM2 decoders (InternLM2's fused ``wqkv`` is a storage
layout: the same products over separate q, k and v weights).

It reads the benchmark's own weights (``harness.weights``) and nothing the
program made. It runs a layer at a time and attention in blocks of
queries, so a 7B forward over a few thousand tokens fits beside nothing
else on one card.

``prec="fp8"`` is the control: every operand of the projections, the MLP
and the LM head rounded to float8 (e4m3, one scale a tensor, its absolute
maximum at 448), and in the backward each gradient that leaves such a
product rounded to e5m2: the step below the bf16 the configurations
state. Attention products stay in float32.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.harness import weights as W
from benchmark.harness.counts import dims


def exact_matmuls() -> None:
    """float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / top
    return ((t / scale).to(dtype).to(t.dtype)) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def _mm(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp8":
        x, w = _Fp8.apply(x), _Fp8.apply(w)
    return x @ w


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, D) at absolute positions ``pos`` (T,)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                       dtype=torch.float64) / d)
    ang = (pos.double()[:, None] * inv[None, :]).float()
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, block: int = 1024) -> torch.Tensor:
    """Causal attention of q (T, H, D) over k, v (T, KV, D), query
    ``i`` seeing keys ``0 .. i``; GQA by repeating the KV heads."""
    t, h, d = q.shape
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)    # (H, T, D)
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    qh = q.transpose(0, 1)
    out = []
    for lo in range(0, t, block):
        hi = min(t, lo + block)
        s = (qh[:, lo:hi] @ k[:, :hi].transpose(1, 2)) * d ** -0.5
        keep = (torch.arange(hi, device=q.device)[None, :]
                <= torch.arange(lo, hi, device=q.device)[:, None])
        s = s.masked_fill(~keep, float("-inf"))
        out.append(torch.softmax(s, dim=-1) @ v[:, :hi])
    return torch.cat(out, dim=1).transpose(0, 1)


def layer(x, lw: Dict[str, torch.Tensor], cfg, pos, prec: str):
    """One decoder block over x (T, E) in float32."""
    m = dims(cfg)
    eps = float(cfg["rms_norm_eps"])
    T, E = x.shape
    h = rms_norm(x, lw["attn_norm"], eps)
    q = _mm(h, lw["wq"].reshape(E, -1), prec).view(T, m["H"], m["D"])
    k = _mm(h, lw["wk"].reshape(E, -1), prec).view(T, m["KV"], m["D"])
    v = _mm(h, lw["wv"].reshape(E, -1), prec).view(T, m["KV"], m["D"])
    theta = float(cfg["rope_theta"])
    a = attention(rope(q, pos, theta), rope(k, pos, theta), v)
    x = x + _mm(a.reshape(T, -1), lw["wo"].reshape(-1, E), prec)
    h = rms_norm(x, lw["mlp_norm"], eps)
    g = _mm(h, lw["w_gate"], prec)
    u = _mm(h, lw["w_up"], prec)
    return x + _mm(F.silu(g) * u, lw["w_down"], prec)


def _layer_weights(tree, i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i].float() for k, v in tree["layers"].items()}


@torch.no_grad()
def logits_at(tree, tokens: torch.Tensor, cfg, positions: Sequence[int],
              prec: str = "fp32") -> torch.Tensor:
    """float32 logits (len(positions), V) of one sequence ``tokens``
    (T,), at ``positions``: the full causal forward, a layer at a time."""
    m = dims(cfg)
    x = tree["tok_embed"][tokens.long()].float()
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    for i in range(m["L"]):
        x = layer(x, _layer_weights(tree, i), cfg, pos, prec)
    x = rms_norm(x[list(positions)], tree["final_norm"].float(),
                 float(cfg["rms_norm_eps"]))
    return _mm(x, tree["lm_head"].float(), prec)


def served_gaps(tree, cfg, prompt: Sequence[int], served: Sequence[int],
                device, prec: str = "fp32", control: bool = False
                ) -> torch.Tensor:
    """Per served token, how far its reference logit lies below the
    reference's best at that position (0 where it is the best). With
    ``control``, the token judged is the one the ``prec`` forward puts
    first, over the same prompt and served tokens."""
    seq = torch.as_tensor(list(prompt) + list(served[:-1]), device=device)
    at = list(range(len(prompt) - 1, len(prompt) - 1 + len(served)))
    ref = logits_at(tree, seq, cfg, at, "fp32")
    if control:
        picked = logits_at(tree, seq, cfg, at, prec).argmax(-1)
    else:
        picked = torch.as_tensor(list(served), device=device)
    return ref.max(-1).values - ref.gather(-1, picked[:, None].long())[:, 0]


# ---------------------------------------------------------------- training


def _row_loss(params, row: torch.Tensor, cfg, prec: str) -> torch.Tensor:
    """Summed next-token cross entropy of one row (S + 1,), each layer
    under ``checkpoint`` (same values, less memory)."""
    m = dims(cfg)
    inputs, targets = row[:-1].long(), row[1:].long()
    x = params["tok_embed"][inputs]
    pos = torch.arange(inputs.shape[0], device=row.device)
    # One unbind a stack: its backward stacks the layers' gradients once.
    stacks = {k: v.unbind(0) for k, v in params["layers"].items()}
    for i in range(m["L"]):
        lw = {k: v[i] for k, v in stacks.items()}
        x = checkpoint(layer, x, lw, cfg, pos, prec, use_reentrant=False)
    x = rms_norm(x, params["final_norm"], float(cfg["rms_norm_eps"]))
    logits = _mm(x, params["lm_head"], prec)
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, targets[:, None])[:, 0]).sum()


def train(cfg, seed: int, batches: List[torch.Tensor], opt: Dict,
          device, prec: str = "fp32") -> Dict[str, object]:
    """AdamW steps on ``batches`` (each (B, S + 1)) from the seeded float32
    weights: each step's mean loss, each leaf's first gradient norm, and
    each leaf's norm of change after the last step. AdamW as published
    (Loshchilov and Hutter; optax's ``adamw``): bias-corrected moments,
    ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` on every leaf."""
    params = W.flat(W.make(cfg, seed, torch.float32, device))
    for p in params.values():
        p.requires_grad_(True)
    tree = {"layers": {}}
    for k, p in params.items():
        if k.startswith("layers/"):
            tree["layers"][k[7:]] = p
        else:
            tree[k] = p
    mom = {k: torch.zeros_like(p) for k, p in params.items()}
    vel = {k: torch.zeros_like(p) for k, p in params.items()}
    b1, b2, eps = opt.get("b1", 0.9), opt.get("b2", 0.999), opt.get(
        "eps", 1e-8)
    lr, wd = opt["learning_rate"], opt["weight_decay"]
    losses, grad_norms = [], {}
    for step, batch in enumerate(batches, start=1):
        total = 0.0
        n = batch.shape[0] * (batch.shape[1] - 1)
        for row in batch:
            loss = _row_loss(tree, row, cfg, prec) / n
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            c1, c2 = 1 - b1 ** step, 1 - b2 ** step
            for k, p in params.items():
                g = p.grad
                if step == 1:
                    grad_norms[k] = float(g.norm())
                mom[k].mul_(b1).add_(g, alpha=1 - b1)
                vel[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (mom[k] / c1) / ((vel[k] / c2).sqrt() + eps)
                p.sub_(lr * (upd + wd * p))
                p.grad = None
    with torch.no_grad():
        change = {k: float((p - W.draw(cfg, seed, k, torch.float32,
                                       device)).norm())
                  for k, p in params.items()}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


def _median(values) -> float:
    vals = sorted(values)
    return vals[len(vals) // 2]


def rounding_leaves(ref_grads: Dict[str, float],
                    floor: float = 1e-3) -> List[str]:
    """Leaves whose reference gradient is nought to rounding: a norm under
    ``floor`` x the median leaf's. Adam moves them by round-off alone."""
    med = _median(ref_grads.values())
    return sorted(k for k, g in ref_grads.items() if g < floor * med)


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   skip: Sequence[str] = ()) -> Dict[str, object]:
    """The largest ``|prog - ref| / max(ref, median ref)`` over the
    leaves not in ``skip``: the gap between the two norms, against the
    leaf's own reference norm or the median leaf's, whichever is
    larger."""
    med = _median(ref.values())
    worst, which = 0.0, None
    for k, r in sorted(ref.items()):
        if k in skip:
            continue
        gap = abs(prog[k] - r) / max(r, med)
        if gap >= worst:
            worst, which = gap, k
    return {"gap": worst, "leaf": which}
