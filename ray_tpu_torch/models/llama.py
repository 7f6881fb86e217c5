"""Llama-family decoder-only transformer (port of ``ray_tpu/models/llama.py``).

Params are a plain dict of tensors under the JAX package's key paths, with
the decoder layers stacked on a leading ``layers`` axis
(``params["layers"]["wq"]`` is (L, E, H, D)); a layer is a dict of views
into those stacks. Every matmul casts its weight to the activations' dtype
per use, as the JAX ``.astype(h.dtype)`` does, so the same code serves two
storages: training keeps fp32 masters (``init_params(dtype=float32)``,
the JAX default) and serving stores the matmul weights once in
``config.dtype`` (bf16 by default), where the cast is a no-op and the
values that reach each matmul are identical. Norm weights stay fp32, as
the JAX ``rms_norm`` reads them in fp32.

Training: ``loss_fn`` (next-token cross entropy, chunked under
``torch.utils.checkpoint`` with ``loss_chunk``), per-layer remat
(``remat_wrap``), the one-hot matmul embedding (``_embed_matmul``),
``param_axes`` and ``flops_per_token``. The JAX ``constrain(...)`` calls
sit at the same places: outside ``parallel.sharding.axis_rules`` (one
device) they are no-ops, and under it, on the DTensors of the mesh train
step, each one redistributes. Attention runs on local shards there
(``_attention``); ``attention_impl="ring"`` is ``ring_attention`` over the
context's mesh. With ``moe_experts`` each layer's MLP is ``ops.moe.moe_ffn``
and ``loss_fn`` adds its load-balance term. With device spans on
(``util.tracing``) the LM head and cross entropy of each chunk are
``lm_head_ce`` spans, forward and backward (``_ce_timed``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.core.device import resolve_device
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rotary import apply_rope, rope_frequencies
from ray_tpu_torch.parallel.sharding import (
    constrain,
    current_mesh,
    current_rules,
    current_shards,
    gather_local,
    placements_for,
    shard_map,
    spec_for,
)
from ray_tpu_torch.util import tracing

Params = Dict[str, Any]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    mlp_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # "xla" | "chunked" (plain PyTorch) | "flash" (the Hopper kernel) |
    # "ring" (ring attention over the seq axis of the axis_rules mesh).
    attention_impl: str = "xla"
    remat: bool = True
    # Remat policy: "full" recomputes each layer in the backward; "dots"
    # saves the matmul outputs and recomputes the rest; "names" saves the
    # attention output and the SwiGLU product (``attn_out`` and
    # ``mlp_hidden`` in the JAX package), and the residual between them.
    # Remat applies only when autograd records the forward.
    remat_policy: str = "full"
    # Cross entropy in sequence chunks of this many tokens (0 = whole
    # sequence): the (B, S, V) fp32 logits are never materialized.
    loss_chunk: int = 0
    # One (E, H+2KV, D) projection for q/k/v and one (E, 2M) for gate/up.
    fused_qkv: bool = False
    fused_mlp: bool = False
    # Embedding lookup as chunked one-hot matmuls (checkpointed per chunk),
    # so its backward is matmuls instead of a scatter-add.
    embed_via_matmul: bool = False
    embed_chunk: int = 512
    # Mixture-of-Experts: moe_experts experts replace the dense MLP (top-k
    # routing, expert-parallel over the mesh's ``expert`` axis).
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def num_params(self) -> int:
        p = self.vocab_size * self.dim
        mlp_params = 3 * self.dim * self.mlp_dim
        if self.moe_experts:
            mlp_params = (self.moe_experts * 3 * self.dim * self.mlp_dim
                          + self.dim * self.moe_experts)
        per_layer = (2 * self.dim
                     + self.dim * self.n_heads * self.head_dim
                     + 2 * self.dim * self.n_kv_heads * self.head_dim
                     + self.n_heads * self.head_dim * self.dim
                     + mlp_params)
        return (p + self.n_layers * per_layer + self.dim
                + self.dim * self.vocab_size)


# Reference shapes: Llama-2 family; "debug"/"160m" are test scales.
PRESETS: Dict[str, LlamaConfig] = {
    "debug": LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, mlp_dim=128, max_seq_len=128),
    "160m": LlamaConfig(vocab_size=32000, dim=768, n_layers=12, n_heads=12,
                        n_kv_heads=12, mlp_dim=2048, max_seq_len=2048),
    "1b": LlamaConfig(vocab_size=32000, dim=2048, n_layers=22, n_heads=16,
                      n_kv_heads=8, mlp_dim=5632, max_seq_len=4096),
    "7b": LlamaConfig(),
    "13b": LlamaConfig(dim=5120, n_layers=40, n_heads=40, n_kv_heads=40,
                       mlp_dim=13824),
    "70b": LlamaConfig(dim=8192, n_layers=80, n_heads=64, n_kv_heads=8,
                       mlp_dim=28672),
}


def config_for(name_or_config) -> LlamaConfig:
    if isinstance(name_or_config, LlamaConfig):
        return name_or_config
    return PRESETS[name_or_config]


# ------------------------------------------------------------------ params


def param_axes(config: Optional[LlamaConfig] = None) -> Dict[str, Any]:
    """Logical axis names, mirroring the params tree (the mesh train step
    places the params by them)."""
    c = config
    layers: Dict[str, Any] = {
        "attn_norm": ("layers", "embed"),
        "wo": ("layers", "heads", "head_dim", "embed"),
        "mlp_norm": ("layers", "embed"),
        "w_down": ("layers", "mlp", "embed"),
    }
    if c is not None and c.fused_qkv:
        layers["wqkv"] = ("layers", "embed", "heads", "head_dim")
    else:
        layers["wq"] = ("layers", "embed", "heads", "head_dim")
        layers["wk"] = ("layers", "embed", "kv_heads", "head_dim")
        layers["wv"] = ("layers", "embed", "kv_heads", "head_dim")
    if c is not None and c.moe_experts:
        layers["moe"] = {
            "router": ("layers", "embed", "expert_dim"),
            "w_gate": ("layers", "expert", "embed", "mlp"),
            "w_up": ("layers", "expert", "embed", "mlp"),
            "w_down": ("layers", "expert", "mlp", "embed"),
        }
    elif c is not None and c.fused_mlp:
        layers["w_gate_up"] = ("layers", "embed", "mlp")
    else:
        layers["w_gate"] = ("layers", "embed", "mlp")
        layers["w_up"] = ("layers", "embed", "mlp")
    return {
        "tok_embed": ("vocab", "embed"),
        "layers": layers,
        "final_norm": ("embed",),
        "lm_head": ("embed", "vocab"),
    }


def decode_param_axes(config: Optional[LlamaConfig] = None
                      ) -> Dict[str, Any]:
    """Logical axes for serving on a decode mesh (``DECODE_RULES``):
    ``param_axes`` with ``wo`` and ``w_down`` fully replicated. Their input
    dims are contracted, so sharding them would split a reduction across
    the mesh; every other projection shards an output dim (heads,
    kv_heads, mlp, vocab over "model") and keeps the single-device
    reduction order."""
    axes = param_axes(config)
    layers = axes["layers"]
    layers["wo"] = ("layers", None, None, None)
    layers["w_down"] = ("layers", None, None)
    return axes


def _layer_shapes(c: LlamaConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """Matmul weights of one layer: name -> (shape, fan_in); the MoE
    weights under ``moe/<name>``."""
    E, H, KV, D, M = c.dim, c.n_heads, c.n_kv_heads, c.head_dim, c.mlp_dim
    # The JAX tree keeps the dense ``w_down`` beside the MoE weights
    # (unused there); so does this one.
    shapes = {"wo": ((H, D, E), H * D), "w_down": ((M, E), M)}
    if c.fused_qkv:
        shapes["wqkv"] = ((E, H + 2 * KV, D), E)
    else:
        shapes.update(wq=((E, H, D), E), wk=((E, KV, D), E),
                      wv=((E, KV, D), E))
    if c.moe_experts:
        X = c.moe_experts
        shapes.update({"moe/router": ((E, X), E),
                       "moe/w_gate": ((X, E, M), E),
                       "moe/w_up": ((X, E, M), E),
                       "moe/w_down": ((X, M, E), M)})
    elif c.fused_mlp:
        shapes["w_gate_up"] = ((E, 2 * M), E)
    else:
        shapes.update(w_gate=((E, M), E), w_up=((E, M), E))
    return shapes


def init_params(config: LlamaConfig,
                generator: Optional[torch.Generator] = None,
                device=None, dtype: Optional[torch.dtype] = None,
                seed: int = 0) -> Params:
    """Random params from ``generator`` (or a new one seeded with ``seed``)
    on ``device`` (``cuda`` unless the caller passes another): normal
    draws scaled by 0.02 (embedding) or 1/sqrt(fan_in), as in the JAX
    package. Matmul weights are stored in ``dtype`` (default
    ``config.dtype``; pass ``torch.float32`` for training masters), norm
    weights in fp32. The generator's numbers differ from ``jax.random``'s; tests
    carry weights across with ``params_from_numpy`` instead. Layers are
    drawn one at a time, so the only fp32 temporary is one layer's
    largest matrix."""
    c = config
    dev = resolve_device(device)
    dt = dtype or c.dtype
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(int(seed))

    def normal(shape, scale, out=None):
        x = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32) * scale
        if out is None:
            return x.to(dt)
        out.copy_(x)
        return out

    L, E = c.n_layers, c.dim
    layers: Dict[str, Any] = {}
    for name, (shape, fan_in) in _layer_shapes(c).items():
        stack = torch.empty((L,) + shape, dtype=dt, device=dev)
        for i in range(L):
            normal(shape, 1.0 / math.sqrt(fan_in), out=stack[i])
        _put(layers, name, stack)
    layers["attn_norm"] = torch.ones((L, E), dtype=torch.float32, device=dev)
    layers["mlp_norm"] = torch.ones((L, E), dtype=torch.float32, device=dev)
    return {
        "tok_embed": normal((c.vocab_size, E), 0.02),
        "layers": layers,
        "final_norm": torch.ones((E,), dtype=torch.float32, device=dev),
        "lm_head": normal((E, c.vocab_size), 1.0 / math.sqrt(E)),
    }


_NORMS = ("attn_norm", "mlp_norm", "final_norm")


def _put(tree: Dict[str, Any], path: str, value) -> None:
    """``tree[a][b] = value`` for ``path`` "a/b"."""
    *outer, name = path.split("/")
    for key in outer:
        tree = tree.setdefault(key, {})
    tree[name] = value


def _flat(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """The leaves of a nested dict by "a/b" path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def params_from_numpy(tree: Dict[str, Any], config: LlamaConfig,
                      device=None, dtype: Optional[torch.dtype] = None
                      ) -> Params:
    """Carry a JAX params pytree, given as numpy arrays
    (``jax.tree.map(np.asarray, params)``), into the port under the same
    key paths. Handles ``wq/wk/wv`` or ``wqkv``, and ``w_gate/w_up``,
    ``w_gate_up`` or the ``moe`` subtree. Matmul weights are stored in
    ``dtype`` (default ``config.dtype``; ``torch.float32`` keeps training
    masters), norm weights in fp32 (see the module docstring)."""
    dev = resolve_device(device)

    def conv(name, arr):
        t = torch.from_numpy(np.asarray(arr, dtype=np.float32).copy())
        dt = torch.float32 if name in _NORMS else (dtype or config.dtype)
        return t.to(device=dev, dtype=dt)

    known = set(_layer_shapes(config)) | {"attn_norm", "mlp_norm"}
    layers: Dict[str, Any] = {}
    for name, arr in _flat(tree["layers"]).items():
        if name not in known:
            raise ValueError(f"unexpected layer param {name!r} for this "
                             f"config (expects {sorted(known)})")
        _put(layers, name, conv(name, arr))
    return {"tok_embed": conv("tok_embed", tree["tok_embed"]),
            "layers": layers,
            "final_norm": conv("final_norm", tree["final_norm"]),
            "lm_head": conv("lm_head", tree["lm_head"])}


def layer_params(params: Params, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s weights: views into the stacked tensors."""
    return {k: v[i] for k, v in params["layers"].items()}


# ----------------------------------------------------------------- forward


def _w(layer, name: str, x: torch.Tensor) -> torch.Tensor:
    """Weight ``name`` in ``x``'s dtype (a no-op for weights stored in it)."""
    return layer[name].to(x.dtype)


def qkv(layer, h: torch.Tensor, config: LlamaConfig):
    """(B, S, E) -> q (B, S, H, D), k and v (B, S, KV, D); one GEMM each
    (one in all with ``wqkv``). The head counts are the weights' own: a
    rank's shards give its local heads."""
    c = config
    b, s, e = h.shape
    if "wqkv" in layer:
        out = (h @ _w(layer, "wqkv", h).reshape(e, -1)).view(
            b, s, -1, c.head_dim)
        # A shard holds the same share of the q, k and v heads.
        nq = out.shape[2] * c.n_heads // (c.n_heads + 2 * c.n_kv_heads)
        nkv = (out.shape[2] - nq) // 2
        return (out[:, :, :nq], out[:, :, nq:nq + nkv],
                out[:, :, nq + nkv:])
    q = (h @ _w(layer, "wq", h).reshape(e, -1)).view(b, s, -1, c.head_dim)
    k = (h @ _w(layer, "wk", h).reshape(e, -1)).view(b, s, -1, c.head_dim)
    v = (h @ _w(layer, "wv", h).reshape(e, -1)).view(b, s, -1, c.head_dim)
    return q, k, v


def out_proj(layer, attn: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) attention output -> (B, S, E) through ``wo``. On local
    shards the heads are gathered first: ``wo`` contracts them."""
    attn = gather_local(attn, 2, "heads")
    b, s = attn.shape[:2]
    wo = _w(layer, "wo", attn)
    out = attn.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])
    return constrain(out, ("batch", "length", "act_embed"))


def mlp_hidden(layer, x: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    """``silu(gate) * up`` of the normed residual (the JAX package's
    ``mlp_hidden``)."""
    h2 = rms_norm(x, layer["mlp_norm"], config.norm_eps)
    if "w_gate_up" in layer:
        gate, up = (h2 @ _w(layer, "w_gate_up", h2)).chunk(2, dim=-1)
    else:
        gate = h2 @ _w(layer, "w_gate", h2)
        up = h2 @ _w(layer, "w_up", h2)
    return constrain(F.silu(gate) * up, ("batch", "length", "mlp_hidden"))


def _down(layer, x: torch.Tensor, ffn: torch.Tensor) -> torch.Tensor:
    ffn = gather_local(ffn, -1, "mlp")  # ``w_down`` contracts the mlp dim
    down = ffn @ _w(layer, "w_down", ffn)
    return x + constrain(down, ("batch", "length", "act_embed"))


def mlp(layer, x: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    """Residual SwiGLU block: ``x + down(silu(gate) * up)``."""
    return _down(layer, x, mlp_hidden(layer, x, config))


def moe_block(layer, x: torch.Tensor, config: LlamaConfig):
    """Residual MoE block: ``(x + moe_ffn(norm(x)), aux)``."""
    from ray_tpu_torch.ops.moe import moe_ffn

    c = config
    h2 = rms_norm(x, layer["mlp_norm"], c.norm_eps)
    out, aux = moe_ffn(h2, layer["moe"], top_k=c.moe_top_k,
                       capacity_factor=c.moe_capacity_factor)
    return x + constrain(out, ("batch", "length", "act_embed")), aux


def _local_attention(config: LlamaConfig, q, k, v, q_offset):
    if config.attention_impl == "flash":
        from ray_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=True, q_offset=q_offset)
    return attention(q, k, v, causal=True, q_offset=q_offset,
                     impl=config.attention_impl)


def _attention(config: LlamaConfig, q, k, v, q_offset):
    """Causal attention by the config's impl. On DTensors it runs on each
    rank's shard of (batch, heads), with the sequence whole: the local
    flash kernel sees plain tensors. A dim its mesh axes do not divide
    stays whole, and so do the heads unless both head counts divide (GQA
    groups must not split)."""
    c = config
    if c.attention_impl == "ring":
        from ray_tpu_torch.parallel.ring_attention import ring_attention

        mesh = current_mesh()
        if mesh is None:
            raise ValueError("attention_impl='ring' requires an axis_rules "
                             "context with a seq-sharded mesh")
        return ring_attention(q, k, v, mesh)
    if not hasattr(q, "device_mesh"):
        return _local_attention(c, q, k, v, q_offset)
    mesh, rules = q.device_mesh, current_rules()

    def divides(name, t, dim):
        spec = spec_for((None,) * dim + (name,), rules)
        return placements_for(mesh, spec, t.shape) == placements_for(mesh,
                                                                     spec)

    batch = "batch" if divides("batch", q, 0) else None
    heads = divides("heads", q, 2) and divides("kv_heads", k, 2)
    spec_q = spec_for((batch, None, "heads" if heads else None), rules)
    spec_kv = spec_for((batch, None, "kv_heads" if heads else None), rules)
    fn = partial(_local_attention, c, q_offset=q_offset)
    return shard_map(fn, mesh, (spec_q, spec_kv, spec_kv), spec_q)(q, k, v)


def attention_block(config: LlamaConfig, x, layer, cos, sin, q_offset=0):
    """Norm, projections, RoPE and attention: ``(attn, k, v)`` with attn
    (B, S, H, D) (the JAX package's ``attn_out``) and the roped k and the
    v it attended with."""
    c = config
    h = rms_norm(x, layer["attn_norm"], c.norm_eps)
    h = constrain(h, ("batch", "length", "act_embed"))
    q, k, v = qkv(layer, h, c)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    q = constrain(q, ("batch", "length", "heads", "head_dim"))
    k = constrain(k, ("batch", "length", "kv_heads", "head_dim"))
    attn = _attention(c, q, k, v, q_offset)
    attn = constrain(attn, ("batch", "length", "attn_heads", "head_dim"))
    return attn, k, v


def decoder_layer_kv(config: LlamaConfig, x, layer, cos, sin, q_offset=0):
    """One decoder block that also returns the roped k and the v it
    attended with (the prefill path caches them): ``(x, k, v)``."""
    attn, k, v = attention_block(config, x, layer, cos, sin, q_offset)
    x = x + out_proj(layer, attn)
    return mlp(layer, x, config), k, v


def _decoder_layer(config: LlamaConfig, x, layer, cos, sin, q_offset=0):
    """One decoder block. ``x``: (B, S, E) in compute dtype."""
    return decoder_layer_kv(config, x, layer, cos, sin, q_offset)[0]


def _layer_parts(config: LlamaConfig, layer, cos, sin) -> Sequence[Callable]:
    """One decoder block as functions chained over tuples, split where the
    "names" policy saves: x -> (x, attn_out) -> (x + out_proj, mlp_hidden)
    -> (block output,); with MoE, x -> (x, attn_out) -> (block output,
    aux)."""
    c = config

    def attn_part(x):
        return x, attention_block(c, x, layer, cos, sin)[0]

    if "moe" in layer:
        def moe_part(x, attn):
            return moe_block(layer, x + out_proj(layer, attn), c)

        return attn_part, moe_part

    def mlp_part(x, attn):
        x = x + out_proj(layer, attn)
        return x, mlp_hidden(layer, x, c)

    def down_part(x, ffn):
        return (_down(layer, x, ffn),)

    return attn_part, mlp_part, down_part


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of the 2-D products (the
    projections and MLP, JAX's dots without batch dims); recompute the rest
    (attention's batched products included)."""
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _chain(parts: Sequence[Callable], x: torch.Tensor) -> tuple:
    carry = (x,)
    for part in parts:
        carry = part(*carry)
    return carry


def remat_wrap(parts: Sequence[Callable], config: LlamaConfig
               ) -> Callable[[torch.Tensor], tuple]:
    """The config's remat policy over one block given as ``_layer_parts``:
    ``"full"`` checkpoints the block (``use_reentrant=False``), ``"dots"``
    checkpoints it under a selective policy that saves the matmul outputs,
    and ``"names"`` checkpoints each part, so what stays alive between the
    parts (the attention output, the residual after it and the SwiGLU
    product) is what is saved. The block input is saved by every policy,
    as the JAX scan carry is. Every policy computes the same values; only
    what the backward recomputes differs. ``None`` means ``"full"`` (the
    JAX ViT's spelling). The wrapped block returns the last part's
    tuple."""
    policy = config.remat_policy
    if policy is None or policy == "full":
        return lambda x: checkpoint(_chain, parts, x, use_reentrant=False)
    if policy == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        ctx = partial(create_selective_checkpoint_contexts, _save_matmuls)
        return lambda x: checkpoint(_chain, parts, x, use_reentrant=False,
                                    context_fn=ctx)
    if policy == "names":
        def run(x):
            carry = (x,)
            for part in parts:
                carry = checkpoint(part, *carry, use_reentrant=False)
            return carry
        return run
    raise ValueError(f"unknown remat_policy {policy!r}")


def rope_tables(config: LlamaConfig, device) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    c = config
    return rope_frequencies(c.head_dim, c.max_seq_len, c.rope_theta,
                            device=device)


def embed(params: Params, tokens: torch.Tensor,
          config: LlamaConfig) -> torch.Tensor:
    # The whole table before the lookup (an all-gather on a mesh), as in
    # the JAX package.
    table = constrain(params["tok_embed"].to(config.dtype), (None, None))
    shards = current_shards()
    if shards is None or shards.axis("vocab") is None:
        return table[tokens.long()]
    # Local shards: each rank looks up the ids in its block of the vocab
    # and zeros the rest; the sum over the blocks adds one row to zeros,
    # which moves no bit.
    lo, hi = shards.block(config.vocab_size, "vocab")
    ids = tokens.long() - lo
    mine = (ids >= 0) & (ids < hi - lo)
    rows = table[ids.clamp(0, hi - lo - 1)]
    return shards.sum(torch.where(mine[..., None], rows,
                                  torch.zeros_like(rows)), "vocab")


def _onehot_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return F.one_hot(tokens.long(), table.shape[0]).to(table.dtype) @ table


def _embed_matmul(table: torch.Tensor, tokens: torch.Tensor,
                  chunk: int = 512) -> torch.Tensor:
    """Embedding gather as chunked one-hot matmuls (``embed_via_matmul``):
    each chunk's one-hot is built, multiplied and, through
    ``torch.utils.checkpoint``, rebuilt in the backward, so the table's
    gradient is ``one_hot^T @ dy`` matmuls instead of a scatter-add. A
    chunk that does not divide B * S shrinks to the largest divisor that
    fits, as in the JAX package."""
    b, s = tokens.shape
    flat = tokens.reshape(-1)
    n = flat.shape[0]
    chunk = min(chunk, n)
    if n % chunk:
        chunk = next(c for c in range(chunk, 0, -1) if n % c == 0)
    grad = torch.is_grad_enabled() and table.requires_grad
    rows = [checkpoint(_onehot_rows, table, flat[i:i + chunk],
                       use_reentrant=False) if grad
            else _onehot_rows(table, flat[i:i + chunk])
            for i in range(0, n, chunk)]
    return torch.cat(rows).view(b, s, -1)


def logits_f32(params: Params, x: torch.Tensor) -> torch.Tensor:
    """LM head with fp32 output, like the JAX einsum of ``x`` and the head
    cast to the compute dtype with ``preferred_element_type=float32``:
    products of bf16 values are exact in fp32, so upcasting both operands
    gives the same sums without rounding the logits to bf16. On local
    shards each rank computes its block of the vocab and the blocks are
    gathered."""
    logits = x.float() @ params["lm_head"].to(x.dtype).float()
    return gather_local(logits, -1, "vocab")


def _unbind_layers(layers: Dict[str, Any]) -> Dict[str, Any]:
    """Each stack (nested for ``moe``) unbound on its layer axis."""
    return {k: _unbind_layers(v) if isinstance(v, dict) else v.unbind(0)
            for k, v in layers.items()}


def _layer_at(stacks: Dict[str, Any], i: int) -> Dict[str, Any]:
    return {k: _layer_at(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacks.items()}


def hidden_states_aux(params: Params, tokens: torch.Tensor,
                      config: LlamaConfig):
    """Token ids (B, S) -> (final-norm hidden states (B, S, E), the MoE
    aux losses summed over layers (0 without MoE)). With ``config.remat``
    and autograd recording, each layer runs under ``remat_wrap``."""
    c = config
    if c.embed_via_matmul:
        x = _embed_matmul(params["tok_embed"].to(c.dtype), tokens,
                          c.embed_chunk)
    else:
        x = embed(params, tokens, c)
    x = constrain(x, ("batch", "length", "act_embed"))
    cos, sin = rope_tables(c, x.device)
    remat = c.remat and torch.is_grad_enabled()
    # One unbind per stack: its backward stacks the layers' gradients in
    # one copy, where indexing each layer would add a zero-filled
    # full-stack gradient per layer (L^2 traffic).
    stacks = _unbind_layers(params["layers"])
    aux = 0.0
    for i in range(c.n_layers):
        parts = _layer_parts(c, _layer_at(stacks, i), cos, sin)
        out = remat_wrap(parts, c)(x) if remat else _chain(parts, x)
        x = out[0]
        if len(out) > 1:
            aux = aux + out[1]
    return rms_norm(x, params["final_norm"], c.norm_eps), aux


def hidden_states(params: Params, tokens: torch.Tensor,
                  config: LlamaConfig) -> torch.Tensor:
    """Token ids (B, S) -> final-norm hidden states (B, S, E)."""
    return hidden_states_aux(params, tokens, config)[0]


def forward(params: Params, tokens: torch.Tensor,
            config: LlamaConfig) -> torch.Tensor:
    """Token ids (B, S) -> logits (B, S, V) in fp32."""
    logits = logits_f32(params, hidden_states(params, tokens, config))
    return constrain(logits, ("batch", "length", "vocab"))


def _ce_sum(x: torch.Tensor, targets: torch.Tensor,
            lm_head: torch.Tensor) -> torch.Tensor:
    """Summed next-token cross entropy of (B, S, E) hidden states against
    (B, S) targets, on fp32 logits. On a mesh the gold logit is read with
    the vocab dim whole."""
    logits = x.float() @ lm_head.float()
    if hasattr(logits, "device_mesh"):
        logits = constrain(logits, ("batch", "length", None))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return (logz - gold).sum()


class _BackwardSpan:
    """The ``lm_head_ce`` span of one chunk's backward: opened where the
    gradient reaches the chunk's output (:class:`_SpanIn`), closed where
    the gradients leave its inputs (:class:`_SpanOut`). It nests under
    the span open on the forward's thread when the backward runs (the
    train step's ``backward`` phase), whichever thread autograd runs it
    on."""

    def __init__(self, device):
        self.device = device
        self.stack = tracing.current_span_stack()
        self.span = None

    def open(self) -> None:
        parent = self.stack[-1] if self.stack else None
        self.span = tracing.device_span("lm_head_ce", self.device, parent)
        self.span.open()

    def close(self) -> None:
        if self.span is not None:
            self.span.close()
            self.span = None


class _SpanIn(torch.autograd.Function):
    """Identity on a chunk's output; its backward opens the span."""

    @staticmethod
    def forward(ctx, box, y):
        ctx.box = box
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        ctx.box.open()
        return None, g


class _SpanOut(torch.autograd.Function):
    """Identity on a chunk's hidden states and LM head; its backward
    closes the span."""

    @staticmethod
    def forward(ctx, box, x, w):
        ctx.box = box
        return x.view_as(x), w.view_as(w)

    @staticmethod
    def backward(ctx, gx, gw):
        ctx.box.close()
        return (None, gx if ctx.needs_input_grad[1] else None,
                gw if ctx.needs_input_grad[2] else None)


def _ce_timed(x: torch.Tensor, targets: torch.Tensor, lm_head: torch.Tensor,
              remat: bool) -> torch.Tensor:
    """``_ce_sum`` of one chunk, under ``checkpoint`` with ``remat``. With
    device spans on, the call is an ``lm_head_ce`` span and, when a
    gradient is to flow, so is its backward (the recompute included),
    bracketed by identities on its inputs and its output."""
    if not tracing.device_spans_on:
        return (checkpoint(_ce_sum, x, targets, lm_head, use_reentrant=False)
                if remat else _ce_sum(x, targets, lm_head))
    box = None
    if torch.is_grad_enabled() and (x.requires_grad or lm_head.requires_grad):
        box = _BackwardSpan(x.device)
        x, lm_head = _SpanOut.apply(box, x, lm_head)
    with tracing.device_span("lm_head_ce", x.device):
        out = (checkpoint(_ce_sum, x, targets, lm_head, use_reentrant=False)
               if remat else _ce_sum(x, targets, lm_head))
    return out if box is None else _SpanIn.apply(box, out)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            config: LlamaConfig) -> torch.Tensor:
    """Next-token cross entropy, a scalar fp32 tensor. ``batch``:
    {"tokens": (B, S+1)} or {"inputs": (B, S), "targets": (B, S)}. With
    ``config.loss_chunk`` dividing S (and smaller than it) the head matmul
    and the cross entropy run per sequence chunk under
    ``torch.utils.checkpoint`` (the JAX ``_chunk_ce``), so the (B, S, V)
    fp32 logits never exist; otherwise on the full fp32 logits. With MoE
    the load-balance term ``moe_aux_coef * aux / n_layers`` is added."""
    c = config
    if "tokens" in batch:
        inputs = batch["tokens"][:, :-1]
        targets = batch["tokens"][:, 1:]
    else:
        inputs, targets = batch["inputs"], batch["targets"]
    x, aux = hidden_states_aux(params, inputs, c)
    lm_head = params["lm_head"].to(c.dtype)
    b, s, _ = x.shape
    chunk = c.loss_chunk
    if chunk and s % chunk == 0 and s > chunk:
        grad = torch.is_grad_enabled() and x.requires_grad
        total = 0.0
        for i in range(0, s, chunk):
            total = total + _ce_timed(x[:, i:i + chunk],
                                      targets[:, i:i + chunk], lm_head, grad)
        loss = total / (b * s)
    else:
        loss = _ce_timed(x, targets, lm_head, False) / (b * s)
    if c.moe_experts:
        loss = loss + c.moe_aux_coef * aux / c.n_layers
    return loss


def flops_per_token(config: LlamaConfig, seq_len: int) -> float:
    """Training FLOPs per token: 6 N for the params (forward and
    backward) plus the attention scores and values, 12 L H D S."""
    c = config
    return (6.0 * c.num_params()
            + 12.0 * c.n_layers * c.n_heads * c.head_dim * seq_len)
