"""Vision Transformer, the second model family (port of
``ray_tpu/models/vit.py``).

Params are a plain dict of tensors under the JAX package's key paths, with
the encoder blocks stacked on a leading ``layers`` axis
(``params["layers"]["wqkv"]`` is (L, E, 3H, D)). As in the JAX package:

* the patch embedding is one product over reshaped patches (a stride =
  kernel = patch convolution written as a matmul's input layout);
* fp32 master params, each cast to ``config.dtype`` where it is used
  (a layer's inside its remat region, as in the JAX scan ``body``), bf16
  compute, an fp32 head product and an fp32 softmax cross entropy;
* a mean-pooled head (no CLS token);
* ``pad_tokens_to`` pads the token axis after the positional add; the
  padded keys are masked in attention and the padded rows are sliced off
  before the pool, so the logits do not change.

The projections and the MLP are 2-D products on (B * N, E), so the
``"dots"`` remat policy (``models.llama.remat_wrap``) saves exactly what
the JAX ``dots_with_no_batch_dims_saveable`` saves: those products, and
not attention's batched ones. ``remat_policy=None`` is full remat.
Attention is the port's plain ``ops.attention.attention`` (the JAX ViT
calls its default ``impl="xla"``, outside any Pallas kernel). The JAX
``constrain(...)`` calls sit at the same places: no-ops on one device,
redistributions of the mesh train step's DTensors under ``axis_rules``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.core.device import resolve_device
from ray_tpu_torch.models.llama import remat_wrap
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.parallel.sharding import constrain

Params = Dict[str, Any]


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 32
    patch_size: int = 4
    channels: int = 3
    num_classes: int = 10
    dim: int = 192
    n_layers: int = 6
    n_heads: int = 3
    mlp_dim: int = 768
    dropout: float = 0.0          # kept for API parity; nothing reads it
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # None = full remat; "dots" keeps the 2-D products' outputs (recompute
    # only the elementwise work and attention).
    remat_policy: Optional[str] = None
    # Pad the token axis to this length inside the model (masked, exact).
    # None = no padding.
    pad_tokens_to: Optional[int] = None

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels


PRESETS: Dict[str, ViTConfig] = {
    "debug": ViTConfig(image_size=16, patch_size=4, dim=64, n_layers=2,
                       n_heads=2, mlp_dim=128, num_classes=10),
    "vit_s16_cifar": ViTConfig(image_size=32, patch_size=4, dim=384,
                               n_layers=12, n_heads=6, mlp_dim=1536),
    "vit_b16": ViTConfig(image_size=224, patch_size=16, dim=768,
                         n_layers=12, n_heads=12, mlp_dim=3072,
                         num_classes=1000),
}


def param_axes(config: Optional[ViTConfig] = None) -> Dict[str, Any]:
    """Logical axis names, mirroring the params tree (the mesh train step
    places the params by them)."""
    return {
        "patch_embed": ("patch", "embed"),
        "pos_embed": ("length", "embed"),
        "layers": {
            "ln1_scale": ("layers", "embed"),
            "ln1_bias": ("layers", "embed"),
            "wqkv": ("layers", "embed", "heads", "head_dim"),
            "wo": ("layers", "heads", "head_dim", "embed"),
            "ln2_scale": ("layers", "embed"),
            "ln2_bias": ("layers", "embed"),
            "w_up": ("layers", "embed", "mlp"),
            "b_up": ("layers", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
            "b_down": ("layers", "embed"),
        },
        "final_ln_scale": ("embed",),
        "final_ln_bias": ("embed",),
        "head": ("embed", "vocab"),
        "head_bias": ("vocab",),
    }


# name -> (shape, init): "ones", "zeros", or the truncated normal's scale.
def _param_specs(c: ViTConfig) -> Dict[str, Any]:
    L, E, H, D, M = c.n_layers, c.dim, c.n_heads, c.head_dim, c.mlp_dim
    return {
        "patch_embed": ((c.patch_dim, E), c.patch_dim ** -0.5),
        "pos_embed": ((c.num_patches, E), 0.02),
        "layers": {
            "ln1_scale": ((L, E), "ones"),
            "ln1_bias": ((L, E), "zeros"),
            "wqkv": ((L, E, 3 * H, D), E ** -0.5),
            "wo": ((L, H, D, E), (H * D) ** -0.5),
            "ln2_scale": ((L, E), "ones"),
            "ln2_bias": ((L, E), "zeros"),
            "w_up": ((L, E, M), E ** -0.5),
            "b_up": ((L, M), "zeros"),
            "w_down": ((L, M, E), M ** -0.5),
            "b_down": ((L, E), "zeros"),
        },
        "final_ln_scale": ((E,), "ones"),
        "final_ln_bias": ((E,), "zeros"),
        "head": ((E, c.num_classes), "zeros"),
        "head_bias": ((c.num_classes,), "zeros"),
    }


def init_params(config: ViTConfig,
                generator: Optional[torch.Generator] = None, device=None,
                dtype: torch.dtype = torch.float32) -> Params:
    """Random params on ``device`` (``cuda`` unless the caller passes
    another) from ``generator`` (a new one seeded with 0 if None): normal
    draws truncated to [-2, 2] times the JAX package's scales, ones and
    zeros where it has them (the head starts at zero). The generator's
    numbers differ from ``jax.random``'s; tests carry weights across with
    ``params_from_numpy`` instead."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        shape, init = spec
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=dev)
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=dev)
        x = torch.empty(shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(x, a=-2.0, b=2.0, generator=generator)
        return (x * init).to(dtype)

    return make(_param_specs(config))


def params_from_numpy(tree: Dict[str, Any], config: ViTConfig, device=None,
                      dtype: Optional[torch.dtype] = None) -> Params:
    """Carry a JAX params pytree, given as numpy arrays
    (``jax.tree.map(np.asarray, params)``), into the port under the same
    key paths, stored in ``dtype`` (default fp32, the JAX masters'). Every
    key and shape must be the config's."""
    dev = resolve_device(device)

    def conv(spec, arr, path):
        if isinstance(spec, dict):
            keys = sorted(arr) if isinstance(arr, dict) else None
            if keys != sorted(spec):
                raise ValueError(f"params at {path or '/'} have keys {keys}, "
                                 f"expected {sorted(spec)}")
            return {k: conv(spec[k], arr[k], f"{path}/{k}") for k in spec}
        a = np.asarray(arr, dtype=np.float32)
        if a.shape != spec[0]:
            raise ValueError(f"param {path} has shape {a.shape}, expected "
                             f"{spec[0]} for this config")
        return torch.from_numpy(a.copy()).to(device=dev,
                                             dtype=dtype or torch.float32)

    return conv(_param_specs(config), tree, "")


def _layer_norm(x, scale, bias, eps: float = 1e-6):
    """LayerNorm in ``x``'s dtype with the population variance."""
    m = x.mean(dim=-1, keepdim=True)
    v = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - m) * torch.rsqrt(v + eps) * scale + bias


def patchify(images: torch.Tensor, config: ViTConfig) -> torch.Tensor:
    """(B, H, W, C) -> (B, N_patches, patch_dim) by pure reshapes (the
    stride-p convolution stem as a matmul's input layout)."""
    b, h, w, ch = images.shape
    p = config.patch_size
    x = images.reshape(b, h // p, p, w // p, p, ch)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * ch)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., K) x (K, N) as one 2-D product on the flattened rows (an
    ``aten.mm``, which the "dots" remat policy saves)."""
    return (x.reshape(-1, x.shape[-1]) @ w).view(*x.shape[:-1], w.shape[-1])


def _block(x, layer, c: ViTConfig, n_valid: Optional[int] = None):
    b, n, e = x.shape
    h = _layer_norm(x, layer["ln1_scale"], layer["ln1_bias"])
    h = constrain(h, ("batch", "length", "act_embed"))
    qkv = _mm(h, layer["wqkv"].reshape(e, -1)).view(b, n, 3 * c.n_heads,
                                                    c.head_dim)
    q, k, v = qkv.split(c.n_heads, dim=2)
    q = constrain(q, ("batch", "length", "heads", "head_dim"))
    out = attention(q, k, v, causal=False, kv_valid=n_valid)
    out = constrain(out, ("batch", "length", "attn_heads", "head_dim"))
    out = _mm(out.reshape(b, n, -1), layer["wo"].reshape(-1, e))
    x = x + constrain(out, ("batch", "length", "act_embed"))

    h2 = _layer_norm(x, layer["ln2_scale"], layer["ln2_bias"])
    up = F.gelu(_mm(h2, layer["w_up"]) + layer["b_up"], approximate="tanh")
    up = constrain(up, ("batch", "length", "mlp_hidden"))
    down = _mm(up, layer["w_down"]) + layer["b_down"]
    return x + constrain(down, ("batch", "length", "act_embed"))


def forward(params: Params, images: torch.Tensor,
            config: ViTConfig) -> torch.Tensor:
    """Images (B, H, W, C) float -> class logits (B, num_classes) fp32.
    With ``config.remat`` and autograd recording, each block runs under
    ``remat_wrap``."""
    c = config
    dt = c.dtype
    x = _mm(patchify(images.to(dt), c), params["patch_embed"].to(dt))
    x = x + params["pos_embed"].to(dt)
    n_tokens = x.shape[1]
    n_valid = None
    if c.pad_tokens_to and c.pad_tokens_to > n_tokens:
        x = F.pad(x, (0, 0, 0, c.pad_tokens_to - n_tokens))
        n_valid = n_tokens
    x = constrain(x, ("batch", "length", "act_embed"))
    remat = c.remat and torch.is_grad_enabled()
    # One unbind per stack (see models.llama.hidden_states).
    stacks = {k: v.unbind(0) for k, v in params["layers"].items()}
    for i in range(c.n_layers):
        layer = {k: t[i] for k, t in stacks.items()}

        def body(x, layer=layer):
            # The JAX scan body and block: the layer's params in the
            # compute dtype, cast inside the remat region (recomputed, not
            # kept).
            cast = {k: v.to(dt) for k, v in layer.items()}
            return (_block(x, cast, c, n_valid),)

        x = (remat_wrap((body,), c) if remat else body)(x)[0]
    x = x[:, :n_tokens]
    x = _layer_norm(x, params["final_ln_scale"].to(dt),
                    params["final_ln_bias"].to(dt))
    pooled = x.mean(dim=1)
    # The JAX einsum of bf16 operands with preferred_element_type=float32:
    # products of bf16 values are exact in fp32.
    logits = pooled.float() @ params["head"].to(dt).float()
    return logits + params["head_bias"].float()


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            config: ViTConfig) -> Tuple[torch.Tensor,
                                        Dict[str, torch.Tensor]]:
    """Softmax cross entropy over ``batch`` = {"images": (B, H, W, C),
    "labels": (B,) integer}; returns (loss, {"accuracy": ...})."""
    logits = forward(params, batch["images"], config)
    if hasattr(logits, "device_mesh"):  # the gold logit with classes whole
        logits = constrain(logits, ("batch", None))
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = (logz - gold).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"accuracy": acc}


def flops_per_image(config: ViTConfig) -> float:
    """Training FLOPs per image, the JAX package's convention: 6 N per
    token for the params a token goes through (not the head, which runs
    once per image on the pooled vector, nor the positional table), the
    head once, and 12 L E N^2 for the attention scores and values."""
    c = config
    tokens = c.num_patches
    head_params = c.dim * c.num_classes
    pos_params = c.num_patches * c.dim
    per_token_params = num_params(c) - head_params - pos_params
    param_flops = 6.0 * per_token_params * tokens + 6.0 * head_params
    attn_flops = 12.0 * c.n_layers * c.dim * tokens * tokens
    return param_flops + attn_flops


def num_params(config: ViTConfig) -> int:
    """Parameter count from the shapes (nothing is allocated)."""
    def count(spec):
        if isinstance(spec, dict):
            return sum(count(v) for v in spec.values())
        return math.prod(spec[0])

    return count(_param_specs(config))
