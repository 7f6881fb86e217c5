"""Pipeline parallelism: model-stage splitting for pipeline stages (port of
``ray_tpu/parallel/pipeline.py``).

This module supplies the model half of the pipeline plane
(``train/pipeline_plane.py``): split a stacked-layer transformer's params
into contiguous stage slices with plain per-stage functions on tensors.
Each stage actor runs ITS slice only; the schedule across stages is the
plane's host-level microbatch pipelining.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ray_tpu_torch.ops.optim import tree_leaves, tree_map


def stage_boundaries(n_layers: int, n_stages: int) -> List[Tuple[int, int]]:
    """Contiguous [start, end) layer ranges, balanced like np.array_split."""
    sizes = [len(part) for part in np.array_split(np.arange(n_layers),
                                                  n_stages)]
    bounds, start = [], 0
    for size in sizes:
        bounds.append((start, start + size))
        start += size
    return bounds


def llama_stage_fn(config, first: bool, last: bool) -> Callable:
    """Plain fn for one Llama pipeline stage: ``fn(stage_params, x)``.
    Stage 0 takes token ids and embeds; middle stages map hidden states;
    the last stage adds final norm + LM head (fp32 logits). The layer
    loop is ``llama.hidden_states_aux``'s: each layer under the config's
    remat policy while autograd records."""
    from ray_tpu_torch.models.llama import (
        _chain,
        _embed_matmul,
        _layer_at,
        _layer_parts,
        _unbind_layers,
        logits_f32,
        remat_wrap,
        rope_tables,
    )
    from ray_tpu_torch.ops.norms import rms_norm

    c = config

    def stage_fn(p, x):
        if first:
            table = p["tok_embed"].to(c.dtype)
            if c.embed_via_matmul:
                h = _embed_matmul(table, x, c.embed_chunk)
            else:
                h = table[x.long()]
        else:
            h = x.to(c.dtype)
        cos, sin = rope_tables(c, h.device)
        # Same remat policy as hidden_states (shared helper): without it,
        # training through a stage keeps every per-layer activation.
        remat = c.remat and torch.is_grad_enabled()
        stacks = _unbind_layers(p["layers"])
        for i in range(tree_leaves(p["layers"])[0].shape[0]):
            parts = _layer_parts(c, _layer_at(stacks, i), cos, sin)
            h = (remat_wrap(parts, c)(h) if remat else _chain(parts, h))[0]
        if last:
            h = rms_norm(h, p["final_norm"], c.norm_eps)
            return logits_f32(p, h)
        return h

    return stage_fn


def split_llama_stages(params: Dict[str, Any], config,
                       n_stages: int) -> List[Tuple[Dict[str, Any],
                                                    Callable]]:
    """Split Llama params into ``n_stages`` contiguous-layer pipeline
    stages (Megatron/GPipe layout). Returns [(stage_params, stage_fn)];
    a stage's layer stacks are views of the full stacks."""
    bounds = stage_boundaries(config.n_layers, n_stages)
    stages: List[Tuple[Dict[str, Any], Callable]] = []
    for idx, (start, end) in enumerate(bounds):
        first, last = idx == 0, idx == n_stages - 1
        stage_params: Dict[str, Any] = {
            "layers": tree_map(lambda x: x[start:end], params["layers"])}
        if first:
            stage_params["tok_embed"] = params["tok_embed"]
        if last:
            stage_params["final_norm"] = params["final_norm"]
            stage_params["lm_head"] = params["lm_head"]
        stages.append((stage_params, llama_stage_fn(config, first, last)))
    return stages


# ------------------------------------------------------ stage training
#
# The MPMD training half ("Scaling Deep Learning Training with MPMD
# Pipeline Parallelism", PAPERS.md): each stage owns its slice's forward
# AND backward as two plain functions. The residual a stage keeps between
# its forward and backward is its INPUT activation (the backward
# recomputes the stage forward under autograd, the same activation-
# recompute schedule ``config.remat`` already applies within a stage,
# lifted to stage granularity), so no autograd graph ever crosses a
# process boundary: activations and gradients move as tensors, residual
# stashes stay stage-local, and 1F1B's memory bound is ``window`` stashed
# inputs per stage instead of every layer's activations.


def llama_stage_loss_fn(config, first: bool) -> Callable:
    """Last-stage head: ``fn(stage_params, x, targets) -> scalar loss``:
    the stage forward's fp32 logits fed through the next-token CE of
    ``llama.loss_fn``'s unchunked path (``logsumexp - gold``, then the
    mean)."""
    base = llama_stage_fn(config, first=first, last=True)

    def fn(p, x, targets):
        logits = base(p, x)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
        return (logz - gold).mean()

    return fn


def _grads(out, cotangent, params: Dict[str, Any], x=None):
    """``(g_params, g_x)`` of ``out`` pulled back with ``cotangent``; the
    gradients lie in the params' tree (a param the stage does not use gets
    zeros, as in JAX)."""
    leaves = tree_leaves(params)
    wrt = leaves + ([x] if x is not None else [])
    grads = torch.autograd.grad(out, wrt, cotangent, allow_unused=True,
                                materialize_grads=True)
    it = iter(grads[:len(leaves)])
    return (tree_map(lambda _: next(it), params),
            grads[-1] if x is not None else None)


def _live(params: Dict[str, Any]) -> Dict[str, Any]:
    return tree_map(lambda t: t.detach().requires_grad_(), params)


def make_stage_train_fns(config, stage_index: int,
                         n_stages: int) -> Tuple[Callable, Callable]:
    """``(fwd, bwd)`` plain functions for one training stage.

    Non-last stage: ``fwd(p, x) -> out`` and ``bwd(p, x, g_out) ->
    (g_params, g_x)``. Last stage: ``fwd(p, x, targets) -> loss`` and
    ``bwd(p, x, targets) -> (loss, g_params, g_x)`` (cotangent 1.0 on the
    scalar loss, so the degenerate 1-stage pipeline reproduces the
    single-process step bit for bit). ``x`` is token ids on stage 0,
    hidden states elsewhere; ``g_x`` on stage 0 is None (token ids have no
    cotangent). ``fwd`` records no graph; ``bwd`` takes the stage INPUT as
    its residual and recomputes the forward under ``torch.enable_grad()``.
    """
    first, last = stage_index == 0, stage_index == n_stages - 1

    if last:
        loss_fn = llama_stage_loss_fn(config, first)

        @torch.no_grad()
        def fwd_last(p, x, targets):
            return loss_fn(p, x, targets)

        def bwd_last(p, x, targets):
            with torch.enable_grad():
                live = _live(p)
                xx = None if first else x.detach().requires_grad_()
                loss = loss_fn(live, x if first else xx, targets)
                one = torch.ones((), dtype=torch.float32, device=loss.device)
                g_params, g_x = _grads(loss, one, live, xx)
            return loss.detach(), g_params, g_x

        return fwd_last, bwd_last

    stage_fn = llama_stage_fn(config, first, last=False)

    @torch.no_grad()
    def fwd(p, x):
        return stage_fn(p, x)

    def bwd(p, x, g_out):
        with torch.enable_grad():
            live = _live(p)
            xx = None if first else x.detach().requires_grad_()
            out = stage_fn(live, x if first else xx)
            return _grads(out, g_out, live, xx)

    return fwd, bwd


def make_stage_worker(config, stage_index: int, n_stages: int,
                      stage_params: Dict[str, Any], device=None) -> Callable:
    """A host-callable closure for one pipeline stage, set up lazily in
    the hosting process: its params move to ``device`` (``cuda`` unless
    the caller passes another) at the first call and the caller's copy is
    released. Tensors in, tensors out."""
    from ray_tpu_torch.core.device import resolve_device

    state: Dict[str, Any] = {"params": stage_params}

    def call(x):
        if "fn" not in state:
            dev = resolve_device(device)
            state["params"] = tree_map(lambda t: t.to(dev),
                                       state["params"])
            state["device"] = dev
            state["fn"] = torch.no_grad()(llama_stage_fn(
                config, stage_index == 0, stage_index == n_stages - 1))
        return state["fn"](state["params"], torch.as_tensor(x).to(
            state["device"]))

    return call
