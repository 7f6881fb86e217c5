"""Operations, bytes, peaks and rooflines, computed from shapes.

Peaks are NVIDIA's data-sheet numbers for one H100 SXM (dense, no
sparsity), at its full 700 W power limit: a card set lower reads a lower
share, so every result carries the card's power limit beside it.

A kernel's roofline share is ``bound / time``, where ``bound =
max(ops / peak FLOP/s, bytes / peak bytes/s)`` is the least time the card
could take for the work these shapes need: each input byte read once,
each output byte written once, and only the (query, key) pairs a mask
keeps. The model-FLOP counts leave out what a program recomputes (remat)
and count a multiply-add as two operations.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Tuple

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
}
DEFAULT_PEAK = "NVIDIA H100 80GB HBM3"


# --------------------------------------------------------------- attention


def causal_pairs(sq: int, sk: int, q_offset: int = 0,
                 causal: bool = True) -> int:
    """(query, key) pairs a causal mask keeps: query ``i`` sits at
    ``q_offset + i`` and sees keys ``0 .. q_offset + i`` of ``sk``."""
    if not causal:
        return sq * sk
    # Rows 0 .. full - 1 see q_offset + i + 1 keys; the rest see all sk.
    full = max(0, min(sq, sk - q_offset))
    return (full * (q_offset + 1) + full * (full - 1) // 2
            + (sq - full) * sk)


def attention_fwd(call: Dict[str, Any]) -> Tuple[float, float]:
    """(ops, bytes) of one attention forward call: ``call`` holds ``b``,
    ``sq``, ``sk``, ``h`` (query heads), ``hkv``, ``d``, ``causal``,
    ``q_offset`` and ``itemsize`` (of q, k, v and the output). QK^T and
    PV are 2 d operations each per kept pair and head; bytes are q, k, v
    and the output once, and the fp32 log-sum-exp."""
    b, sq, sk = call["b"], call["sq"], call["sk"]
    h, hkv, d, it = call["h"], call["hkv"], call["d"], call["itemsize"]
    pairs = causal_pairs(sq, sk, call.get("q_offset", 0),
                         call.get("causal", True))
    ops = 4.0 * b * h * d * pairs
    nbytes = it * b * d * (2 * sq * h + 2 * sk * hkv) + 4.0 * b * h * sq
    return ops, float(nbytes)


def attention_bwd(call: Dict[str, Any]) -> Tuple[float, float]:
    """(ops, bytes) of one attention backward call, shapes as in
    :func:`attention_fwd`: per kept pair and head the recomputed QK^T, dP
    = dO V^T, dV += P^T dO, dQ += dS K and dK += dS^T Q, 2 d each. Bytes:
    q, k, v, o and dO read, dq, dk and dv written, and the fp32
    log-sum-exp read."""
    b, sq, sk = call["b"], call["sq"], call["sk"]
    h, hkv, d, it = call["h"], call["hkv"], call["d"], call["itemsize"]
    pairs = causal_pairs(sq, sk, call.get("q_offset", 0),
                         call.get("causal", True))
    ops = 10.0 * b * h * d * pairs
    nbytes = it * b * d * (4 * sq * h + 4 * sk * hkv) + 4.0 * b * h * sq
    return ops, float(nbytes)


def roofline_share(calls: Iterable[Dict[str, Any]], device_s: float,
                   counter, pk: Dict[str, float]) -> Dict[str, Any]:
    """The calls' summed bound over ``device_s``, in %, and which of
    operations and bytes bounds the sum."""
    ops = nbytes = bound = 0.0
    for call in calls:
        o, n = counter(call)
        ops += o
        nbytes += n
        bound += max(o / pk["bf16_flops"], n / pk["hbm_bytes_per_s"])
    by = ("operations" if ops / pk["bf16_flops"]
          >= nbytes / pk["hbm_bytes_per_s"] else "bytes")
    return {"share_pct": 100.0 * bound / device_s, "ops": ops,
            "bytes": nbytes, "bound_s": bound, "bound_by": by}


# ------------------------------------------------------------------ models


def dims(cfg: Dict[str, Any]) -> Dict[str, int]:
    """The sizes the counts use, from a configuration file (Hugging Face
    key names)."""
    h = int(cfg["num_attention_heads"])
    e = int(cfg["hidden_size"])
    return {"L": int(cfg["num_hidden_layers"]), "E": e, "H": h,
            "KV": int(cfg["num_key_value_heads"]),
            "D": int(cfg.get("head_dim") or e // h),
            "M": int(cfg["intermediate_size"]), "V": int(cfg["vocab_size"])}


def layer_params(cfg: Dict[str, Any]) -> int:
    """Matmul parameters of the decoder layers (q, k, v, o and the SwiGLU
    MLP), all layers."""
    m = dims(cfg)
    attn = m["E"] * m["D"] * (2 * m["H"] + 2 * m["KV"])
    mlp = 3 * m["E"] * m["M"]
    return m["L"] * (attn + mlp)


def head_params(cfg: Dict[str, Any]) -> int:
    m = dims(cfg)
    return m["E"] * m["V"]


def train_flops_per_token(cfg: Dict[str, Any], seq_len: int) -> float:
    """Model FLOPs of one trained token at sequence length ``seq_len``:
    6 x the non-embedding parameters with the LM head (forward and
    backward), plus causal attention, 6 L H D S (half of the 12 L H D S of
    a full mask: a token at position p attends p + 1 keys, on average
    (S + 1) / 2). The embedding lookup is no matmul and counts nothing;
    recomputation counts nothing."""
    m = dims(cfg)
    pairs_per_token = (seq_len + 1) / 2.0
    return (6.0 * (layer_params(cfg) + head_params(cfg))
            + 12.0 * m["L"] * m["H"] * m["D"] * pairs_per_token)


def serve_token_flops(cfg: Dict[str, Any], position: int,
                      logits: bool) -> float:
    """Model FLOPs of one served token at ``position`` (0-based) of its
    sequence: 2 x the layers' matmul parameters, attention over its
    position + 1 keys (4 L H D a key), and the LM head (2 E V) where the
    token's logits are needed (the last prompt token and every decoded
    token)."""
    m = dims(cfg)
    f = 2.0 * layer_params(cfg) + 4.0 * m["L"] * m["H"] * m["D"] * (
        position + 1)
    if logits:
        f += 2.0 * head_params(cfg)
    return f


def prompt_flops(cfg: Dict[str, Any], n: int) -> float:
    """Model FLOPs of prefilling an ``n``-token prompt (logits at its last
    token only), in closed form: the sum of :func:`serve_token_flops` over
    positions ``0 .. n - 1``."""
    m = dims(cfg)
    return (2.0 * layer_params(cfg) * n
            + 4.0 * m["L"] * m["H"] * m["D"] * n * (n + 1) / 2.0
            + 2.0 * head_params(cfg))
