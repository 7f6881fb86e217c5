"""Mixture-of-Experts FFN with expert parallelism (port of
``ray_tpu/ops/moe.py``).

The GShard/Switch dispatch as einsums, as in the JAX package:

    router logits -> top-k gates -> capacity-bounded dispatch mask
    expert_in  (E, C, D)  = dispatch^T tokens
    expert_out (E, C, D)  = per-expert FFN (batched matmul, E sharded)
    out        (T, D)     = combine expert_out

Tokens past an expert's capacity are dropped (the residual stream carries
them). Gates are renormalized over the chosen top-k, except at k = 1.
Under ``axis_rules`` the expert dims are constrained to the ``expert``
mesh axis and DTensor turns the einsums into the token exchange; the
routing itself (a cumulative count over all tokens) runs replicated, on
every token, as the JAX program computes it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.parallel.sharding import constrain, shard_map


def router_topk(logits: torch.Tensor, k: int, capacity: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing with per-expert capacity on (T, E) fp32 logits:
    (dispatch (T, E, C) one-hot, combine (T, E, C) gate weights). Ties
    pick the lower expert index first (``lax.top_k``'s order); a token's
    place in an expert's queue counts the choices before it, token-major
    then choice-minor."""
    t, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[:, :k], expert_idx[:, :k]
    if k > 1:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(
            1e-9)
    choice_onehot = F.one_hot(expert_idx, e)                 # (T, k, E)
    flat = choice_onehot.reshape(t * k, e)
    positions = (torch.cumsum(flat, dim=0) - flat).reshape(t, k, e)
    pos_in_expert = (positions * choice_onehot).sum(-1)      # (T, k)
    keep = pos_in_expert < capacity
    slot = (F.one_hot(torch.where(keep, pos_in_expert, 0), capacity)
            * keep[..., None]).float()                       # (T, k, C)
    routed = choice_onehot.float()[..., None] * slot[:, :, None, :]
    dispatch = routed.sum(1)
    if k == 1:
        combine = dispatch * gate_vals.sum(1)[:, None, None]
    else:
        combine = (routed * gate_vals[..., None, None]).sum(1)
    return dispatch, combine


def _route(logits: torch.Tensor, k: int, capacity: int):
    """``router_topk`` on every token: a DTensor is gathered first and the
    routing comes back replicated."""
    if not hasattr(logits, "device_mesh"):
        return router_topk(logits, k, capacity)
    fn = shard_map(lambda lg: router_topk(lg, k, capacity),
                   logits.device_mesh, [()], [(), ()])
    return fn(logits)


def moe_ffn(x: torch.Tensor, params: Dict[str, Any], top_k: int = 2,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward on (B, S, D): (output (B, S, D), aux load-balance
    loss in fp32). ``params``: router (D, E); w_gate / w_up (E, D, M);
    w_down (E, M, D)."""
    b, s, d = x.shape
    e = params["router"].shape[-1]
    t = b * s
    capacity = max(1, int(capacity_factor * top_k * t / e))
    tokens = x.reshape(t, d)
    logits = tokens.float() @ params["router"].float()
    dispatch, combine = _route(logits, top_k, capacity)

    probs = torch.softmax(logits, dim=-1)
    frac_tokens = dispatch.sum((0, 2)) / dispatch.sum().clamp_min(1.0)
    aux = e * (frac_tokens * probs.mean(0)).sum()

    compute = x.dtype
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(compute), tokens)
    expert_in = constrain(expert_in, ("expert", None, None))
    gate = torch.einsum("ecd,edm->ecm", expert_in,
                        params["w_gate"].to(compute))
    up = torch.einsum("ecd,edm->ecm", expert_in, params["w_up"].to(compute))
    act = F.silu(gate) * up
    expert_out = torch.einsum("ecm,emd->ecd", act,
                              params["w_down"].to(compute))
    expert_out = constrain(expert_out, ("expert", None, None))
    out = torch.einsum("tec,ecd->td", combine.to(compute), expert_out)
    return out.reshape(b, s, d), aux.float()


def init_moe_params(dim: int, mlp_dim: int, num_experts: int,
                    generator: Optional[torch.Generator] = None,
                    device=None, dtype=torch.float32, seed: int = 0
                    ) -> Dict[str, torch.Tensor]:
    """Normal draws over sqrt(fan_in), as the JAX package's; the numbers
    differ from ``jax.random``'s (tests carry weights across as numpy)."""
    from ray_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(int(seed))

    def normal(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=dev)
                / math.sqrt(fan_in)).to(dtype)

    return {
        "router": normal((dim, num_experts), dim),
        "w_gate": normal((num_experts, dim, mlp_dim), dim),
        "w_up": normal((num_experts, dim, mlp_dim), dim),
        "w_down": normal((num_experts, mlp_dim, dim), mlp_dim),
    }


def moe_param_axes() -> Dict[str, Any]:
    return {
        "router": ("embed", "expert_dim"),
        "w_gate": ("expert", "embed", "mlp"),
        "w_up": ("expert", "embed", "mlp"),
        "w_down": ("expert", "mlp", "embed"),
    }
