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
are sharding hints; on one device they are no-ops, so the port drops them.
The MoE fields are not ported (ROADMAP.md queue 1, item 3).
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

from ray_tpu_torch.core.device import not_ported, resolve_device
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rotary import apply_rope, rope_frequencies

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
    # "ring" (not ported yet: raises).
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

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def num_params(self) -> int:
        p = self.vocab_size * self.dim
        per_layer = (2 * self.dim
                     + self.dim * self.n_heads * self.head_dim
                     + 2 * self.dim * self.n_kv_heads * self.head_dim
                     + self.n_heads * self.head_dim * self.dim
                     + 3 * self.dim * self.mlp_dim)
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


def _check_ported(config: LlamaConfig) -> None:
    if config.attention_impl == "ring":
        raise not_ported("attention_impl='ring'",
                         "item 3, meshes with ring, Ulysses and MoE")


# ------------------------------------------------------------------ params


def param_axes(config: Optional[LlamaConfig] = None) -> Dict[str, Any]:
    """Logical axis names, mirroring the params tree (metadata: the port
    runs on one device, so nothing reads them to shard yet)."""
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
    if c is not None and c.fused_mlp:
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


def _layer_shapes(c: LlamaConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """Matmul weights of one layer: name -> (shape, fan_in)."""
    E, H, KV, D, M = c.dim, c.n_heads, c.n_kv_heads, c.head_dim, c.mlp_dim
    shapes = {"wo": ((H, D, E), H * D), "w_down": ((M, E), M)}
    if c.fused_qkv:
        shapes["wqkv"] = ((E, H + 2 * KV, D), E)
    else:
        shapes.update(wq=((E, H, D), E), wk=((E, KV, D), E),
                      wv=((E, KV, D), E))
    if c.fused_mlp:
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
    layers: Dict[str, torch.Tensor] = {}
    for name, (shape, fan_in) in _layer_shapes(c).items():
        stack = torch.empty((L,) + shape, dtype=dt, device=dev)
        for i in range(L):
            normal(shape, 1.0 / math.sqrt(fan_in), out=stack[i])
        layers[name] = stack
    layers["attn_norm"] = torch.ones((L, E), dtype=torch.float32, device=dev)
    layers["mlp_norm"] = torch.ones((L, E), dtype=torch.float32, device=dev)
    return {
        "tok_embed": normal((c.vocab_size, E), 0.02),
        "layers": layers,
        "final_norm": torch.ones((E,), dtype=torch.float32, device=dev),
        "lm_head": normal((E, c.vocab_size), 1.0 / math.sqrt(E)),
    }


_NORMS = ("attn_norm", "mlp_norm", "final_norm")


def params_from_numpy(tree: Dict[str, Any], config: LlamaConfig,
                      device=None, dtype: Optional[torch.dtype] = None
                      ) -> Params:
    """Carry a JAX params pytree, given as numpy arrays
    (``jax.tree.map(np.asarray, params)``), into the port under the same
    key paths. Handles ``wq/wk/wv`` or ``wqkv`` and ``w_gate/w_up`` or
    ``w_gate_up``. Matmul weights are stored in ``dtype`` (default
    ``config.dtype``; ``torch.float32`` keeps training masters), norm
    weights in fp32 (see the module docstring)."""
    dev = resolve_device(device)

    def conv(name, arr):
        t = torch.from_numpy(np.asarray(arr, dtype=np.float32).copy())
        dt = torch.float32 if name in _NORMS else (dtype or config.dtype)
        return t.to(device=dev, dtype=dt)

    known = set(_layer_shapes(config)) | {"attn_norm", "mlp_norm"}
    layers = {}
    for name, arr in tree["layers"].items():
        if name not in known:
            raise ValueError(f"unexpected layer param {name!r} for this "
                             f"config (expects {sorted(known)})")
        layers[name] = conv(name, arr)
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
    (one in all with ``wqkv``)."""
    c = config
    b, s, e = h.shape
    if "wqkv" in layer:
        out = (h @ _w(layer, "wqkv", h).reshape(e, -1)).view(
            b, s, -1, c.head_dim)
        return (out[:, :, :c.n_heads],
                out[:, :, c.n_heads:c.n_heads + c.n_kv_heads],
                out[:, :, c.n_heads + c.n_kv_heads:])
    q = (h @ _w(layer, "wq", h).reshape(e, -1)).view(b, s, c.n_heads,
                                                    c.head_dim)
    k = (h @ _w(layer, "wk", h).reshape(e, -1)).view(b, s, c.n_kv_heads,
                                                    c.head_dim)
    v = (h @ _w(layer, "wv", h).reshape(e, -1)).view(b, s, c.n_kv_heads,
                                                    c.head_dim)
    return q, k, v


def out_proj(layer, attn: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) attention output -> (B, S, E) through ``wo``."""
    b, s = attn.shape[:2]
    wo = _w(layer, "wo", attn)
    return attn.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])


def mlp_hidden(layer, x: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    """``silu(gate) * up`` of the normed residual (the JAX package's
    ``mlp_hidden``)."""
    h2 = rms_norm(x, layer["mlp_norm"], config.norm_eps)
    if "w_gate_up" in layer:
        gate, up = (h2 @ _w(layer, "w_gate_up", h2)).chunk(2, dim=-1)
    else:
        gate = h2 @ _w(layer, "w_gate", h2)
        up = h2 @ _w(layer, "w_up", h2)
    return F.silu(gate) * up


def mlp(layer, x: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    """Residual SwiGLU block: ``x + down(silu(gate) * up)``."""
    ffn = mlp_hidden(layer, x, config)
    return x + ffn @ _w(layer, "w_down", ffn)


def attention_block(config: LlamaConfig, x, layer, cos, sin, q_offset=0):
    """Norm, projections, RoPE and attention: ``(attn, k, v)`` with attn
    (B, S, H, D) (the JAX package's ``attn_out``) and the roped k and the
    v it attended with."""
    c = config
    h = rms_norm(x, layer["attn_norm"], c.norm_eps)
    q, k, v = qkv(layer, h, c)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    _check_ported(c)
    if c.attention_impl == "flash":
        from ray_tpu_torch.ops.flash_attention import flash_attention

        attn = flash_attention(q, k, v, causal=True, q_offset=q_offset)
    else:
        attn = attention(q, k, v, causal=True, q_offset=q_offset,
                         impl=c.attention_impl)
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
    """One decoder block as three functions chained over tuples, split
    where the "names" policy saves: x -> (x, attn_out) ->
    (x + out_proj, mlp_hidden) -> block output."""
    c = config

    def attn_part(x):
        return x, attention_block(c, x, layer, cos, sin)[0]

    def mlp_part(x, attn):
        x = x + out_proj(layer, attn)
        return x, mlp_hidden(layer, x, c)

    def down_part(x, ffn):
        return (x + ffn @ _w(layer, "w_down", ffn),)

    return attn_part, mlp_part, down_part


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of the 2-D products (the
    projections and MLP, JAX's dots without batch dims); recompute the rest
    (attention's batched products included)."""
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _chain(parts: Sequence[Callable], x: torch.Tensor) -> torch.Tensor:
    carry = (x,)
    for part in parts:
        carry = part(*carry)
    return carry[0]


def remat_wrap(parts: Sequence[Callable], config: LlamaConfig
               ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The config's remat policy over one block given as ``_layer_parts``:
    ``"full"`` checkpoints the block (``use_reentrant=False``), ``"dots"``
    checkpoints it under a selective policy that saves the matmul outputs,
    and ``"names"`` checkpoints each part, so what stays alive between the
    parts (the attention output, the residual after it and the SwiGLU
    product) is what is saved. The block input is saved by every policy,
    as the JAX scan carry is. Every policy computes the same values; only
    what the backward recomputes differs. ``None`` means ``"full"`` (the
    JAX ViT's spelling)."""
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
            return carry[0]
        return run
    raise ValueError(f"unknown remat_policy {policy!r}")


def rope_tables(config: LlamaConfig, device) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    c = config
    return rope_frequencies(c.head_dim, c.max_seq_len, c.rope_theta,
                            device=device)


def embed(params: Params, tokens: torch.Tensor,
          config: LlamaConfig) -> torch.Tensor:
    return params["tok_embed"].to(config.dtype)[tokens.long()]


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
    gives the same sums without rounding the logits to bf16."""
    return x.float() @ params["lm_head"].to(x.dtype).float()


def hidden_states(params: Params, tokens: torch.Tensor,
                  config: LlamaConfig) -> torch.Tensor:
    """Token ids (B, S) -> final-norm hidden states (B, S, E). With
    ``config.remat`` and autograd recording, each layer runs under
    ``remat_wrap``."""
    c = config
    _check_ported(c)
    if c.embed_via_matmul:
        x = _embed_matmul(params["tok_embed"].to(c.dtype), tokens,
                          c.embed_chunk)
    else:
        x = embed(params, tokens, c)
    cos, sin = rope_tables(c, x.device)
    remat = c.remat and torch.is_grad_enabled()
    # One unbind per stack: its backward stacks the layers' gradients in
    # one copy, where indexing each layer would add a zero-filled
    # full-stack gradient per layer (L^2 traffic).
    stacks = {k: v.unbind(0) for k, v in params["layers"].items()}
    for i in range(c.n_layers):
        layer = {k: t[i] for k, t in stacks.items()}
        parts = _layer_parts(c, layer, cos, sin)
        x = remat_wrap(parts, c)(x) if remat else _chain(parts, x)
    return rms_norm(x, params["final_norm"], c.norm_eps)


def forward(params: Params, tokens: torch.Tensor,
            config: LlamaConfig) -> torch.Tensor:
    """Token ids (B, S) -> logits (B, S, V) in fp32."""
    return logits_f32(params, hidden_states(params, tokens, config))


def _ce_sum(x: torch.Tensor, targets: torch.Tensor,
            lm_head: torch.Tensor) -> torch.Tensor:
    """Summed next-token cross entropy of (B, S, E) hidden states against
    (B, S) targets, on fp32 logits."""
    logits = x.float() @ lm_head.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return (logz - gold).sum()


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            config: LlamaConfig) -> torch.Tensor:
    """Next-token cross entropy, a scalar fp32 tensor. ``batch``:
    {"tokens": (B, S+1)} or {"inputs": (B, S), "targets": (B, S)}. With
    ``config.loss_chunk`` dividing S (and smaller than it) the head matmul
    and the cross entropy run per sequence chunk under
    ``torch.utils.checkpoint`` (the JAX ``_chunk_ce``), so the (B, S, V)
    fp32 logits never exist; otherwise on the full fp32 logits."""
    c = config
    if "tokens" in batch:
        inputs = batch["tokens"][:, :-1]
        targets = batch["tokens"][:, 1:]
    else:
        inputs, targets = batch["inputs"], batch["targets"]
    x = hidden_states(params, inputs, c)
    lm_head = params["lm_head"].to(c.dtype)
    b, s, _ = x.shape
    chunk = c.loss_chunk
    if chunk and s % chunk == 0 and s > chunk:
        grad = torch.is_grad_enabled() and x.requires_grad
        total = 0.0
        for i in range(0, s, chunk):
            args = (x[:, i:i + chunk], targets[:, i:i + chunk], lm_head)
            total = total + (checkpoint(_ce_sum, *args, use_reentrant=False)
                             if grad else _ce_sum(*args))
        return total / (b * s)
    return _ce_sum(x, targets, lm_head) / (b * s)


def flops_per_token(config: LlamaConfig, seq_len: int) -> float:
    """Training FLOPs per token: 6 N for the params (forward and
    backward) plus the attention scores and values, 12 L H D S."""
    c = config
    return (6.0 * c.num_params()
            + 12.0 * c.n_layers * c.n_heads * c.head_dim * seq_len)
