"""What both drivers share: the program's config from a configuration
file, the process clock, and freeing the program before the reference
runs."""

from __future__ import annotations

import gc
from dataclasses import replace
from typing import Any, Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def llama_config(cfg: Dict[str, Any], model: Dict[str, Any],
                 max_seq_len: int):
    """The port's ``LlamaConfig`` for a configuration file (Hugging Face
    keys) and a mix's ``model`` settings. Refuses what the port's Llama
    path does not compute: a head size other than hidden / heads, tied
    embeddings, a sliding window, an activation other than SiLU, or rope
    scaling that acts at the positions the mix reaches."""
    from ray_tpu_torch.models.llama import LlamaConfig

    e, h = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    if int(cfg.get("head_dim") or e // h) != e // h:
        raise ValueError("the port's head size is hidden_size / heads")
    if cfg.get("tie_word_embeddings"):
        raise ValueError("the port's LM head is untied")
    if cfg.get("sliding_window"):
        raise ValueError("the port's Llama attention has no window")
    if cfg.get("hidden_act", "silu") != "silu":
        raise ValueError("the port's MLP is SwiGLU")
    scaling = cfg.get("rope_scaling")
    if scaling and max_seq_len > int(cfg["max_position_embeddings"]):
        raise ValueError("rope scaling acts past max_position_embeddings")
    c = LlamaConfig(
        vocab_size=int(cfg["vocab_size"]), dim=e,
        n_layers=int(cfg["num_hidden_layers"]), n_heads=h,
        n_kv_heads=int(cfg["num_key_value_heads"]),
        mlp_dim=int(cfg["intermediate_size"]), max_seq_len=max_seq_len,
        rope_theta=float(cfg["rope_theta"]),
        norm_eps=float(cfg["rms_norm_eps"]))
    return replace(c, dtype=DTYPES[model["dtype"]],
                   attention_impl=model["attention_impl"],
                   **{k: model[k] for k in ("remat", "remat_policy",
                                            "loss_chunk") if k in model})


def free_device() -> None:
    """Return what the freed program held to the card, so the reference
    runs in its place."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    return (int(torch.cuda.max_memory_allocated())
            if torch.device(device).type == "cuda" else 0)


def setup_parts(t_proc: float, marks: Dict[str, float], t0: float
                ) -> Dict[str, float]:
    """``setup_s`` split at ``marks`` (host times, in the order taken):
    the seconds from the mark before each to it, the window's opening
    last."""
    out, prev = {}, t_proc
    for name, t in list(marks.items()) + [("to_window", t0)]:
        out[name] = round(t - prev, 3)
        prev = t
    return out
