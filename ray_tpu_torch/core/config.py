"""Process-wide typed knobs of the serving path (copy of the part of
``ray_tpu/core/config.py`` that the decode engine reads).

Same names, types and defaults as the JAX package. ``RAY_TPU_<NAME>`` env
vars override at import time; ``config.update({...})`` or attribute
assignment overrides at run time. The knob the port does not carry yet (a
decode mesh) is declared so that a non-default value can be refused by
name.
"""

from __future__ import annotations

import os
from typing import Any, Dict

_FLAG_DEFS: Dict[str, tuple] = {
    # (type, default, doc)
    "prefix_pool_entries": (int, 8,
        "Entries in a DecodeEngine's device-resident prefix KV pool: cached "
        "prompt prefixes spliced into a request's slot at admission so only "
        "the uncached suffix is prefilled. Each entry costs "
        "2 * L * C_prefix * KV * D cache bytes. 0 disables the prefix cache."),
    "prefix_match_min_tokens": (int, 16,
        "Minimum shared-prefix length (tokens) for a prefix-cache hit; "
        "prompts shorter than this are neither matched nor inserted."),
    "decode_queue_max": (int, 0,
        "Cap on a DecodeEngine's pending (unadmitted) request queue. Past "
        "it, submit() sheds the request with OverloadedError. "
        "0 = slots * 8."),
    "kv_page_tokens": (int, 0,
        "Page size (tokens) of a DecodeEngine's paged KV pool. >0 switches "
        "the engine from per-slot monolithic cache rows to a shared device "
        "pool of fixed-size pages addressed through per-slot block tables "
        "(vLLM-style paged attention on static shapes): slots consume only "
        "the pages their sequence actually covers, prefix sharing splices "
        "block-table entries with zero device copies, and eviction frees "
        "page-granular tail segments. Must divide the engine capacity. "
        "0 = contiguous whole-row cache (pre-paging behavior)."),
    "kv_pool_pages": (int, 0,
        "Pages in a paged DecodeEngine's device KV pool. The pool may be "
        "OVERCOMMITTED (pages < slots * capacity / kv_page_tokens): more "
        "concurrent sequences fit the same HBM bytes, and when the pool "
        "truly runs dry the engine reclaims prefix-cache pins first and "
        "then preempts the youngest request (recompute-style requeue). "
        "0 = slots * capacity / kv_page_tokens (no overcommit)."),
    "kv_prefix_max_pages": (int, 0,
        "Cap on pool pages pinned by the paged prefix index (cached "
        "prompt prefixes kept resident after their request completes). "
        "Past it, least-recently-used tail pages unpin first. "
        "0 = kv_pool_pages // 4."),
    "prefill_chunk_tokens": (int, 0,
        "Chunked-prefill interleaving for paged DecodeEngines: prompt "
        "prefills longer than this run as a sequence of at most one "
        "chunk-sized prefill program per decode step, scheduled between "
        "decode steps — a long admission can stall active streams for at "
        "most ONE chunk instead of its whole prefill. 0 disables "
        "(monolithic prefill at admission, pre-chunking behavior)."),
    "spec_k": (int, 0,
        "Speculative-decoding depth for DecodeEngines given a draft "
        "model: a small draft model proposes k tokens per active slot "
        "per step and the target model verifies all k+1 positions in "
        "ONE batched forward (the paged ragged-position gather), so a "
        "step emits 1..k+1 tokens per slot. Each emitted token is the "
        "target's argmax at its position (longest-matching-prefix "
        "acceptance); sampled (temperature > 0) requests fall back to "
        "per-token decode. Requires paged KV (kv_page_tokens > 0). "
        "0 disables."),
    "spec_draft_model": (str, "",
        "Draft-model preset name (models/llama.PRESETS) for "
        "LlamaDecodeDeployment's speculative mode, a model a few times "
        "smaller than the target preset over the same vocab. Empty "
        "disables spec mode at the deployment level; engines constructed "
        "directly take draft params/config explicitly."),
    "spec_draft_pool_pages": (int, 0,
        "Pages in the draft model's OWN paged KV pool (spec mode). The "
        "draft tracks the same sequence positions as the target but at "
        "draft-model width, so its pool is the same page count at a "
        "fraction of the bytes. A dry draft pool evicts younger draft "
        "seats or leaves a slot draftless; it never preempts a request. "
        "0 = match kv_pool_pages."),
    "decode_device_sampler": (bool, False,
        "Fold sampling into the decode step on the device (argmax, or a "
        "per-row categorical draw at the row's temperature) so each step "
        "returns token ids instead of copying (slots, vocab) logits to "
        "the host sampler. Greedy rows are identical to the host "
        "sampler's; temperature > 0 rows draw from a torch.Generator "
        "seeded from the step (a different stream than the host "
        "sampler's numpy generator and than the JAX package's device "
        "stream), which is why this is opt-in."),
    "decode_warmup": (bool, False,
        "Pre-dispatch a DecodeEngine's steady-state step set (decode, "
        "decode-chunk grid, spec draft/verify, device sampler, one "
        "prefill bucket) at deployment construction, so the first "
        "requests do not pay the first call of each (on a card: the "
        "flash kernel's build, cuBLAS's first call of each shape). The "
        "steplog's jit-compile events then show only the prefill "
        "buckets the live prompt mix reaches."),
    "decode_step_timeline": (int, 256,
        "Entries in a DecodeEngine's step-timeline ring "
        "(serve/steplog.py): per-step phases (prefill waves, prefill "
        "chunk, decode, draft, verify), batch occupancy and page "
        "alloc/free, preempt, spec-draftless and jit-compile events, "
        "read through engine.timeline() and stats(). 0 disables the "
        "recorder."),
    "decode_mesh_shape": (str, "",
        "Default (batch, model) decode mesh. Empty = one device."),
}


class _Config:
    def __init__(self):
        self._values: Dict[str, Any] = {}
        for name, (typ, default, _doc) in _FLAG_DEFS.items():
            env = os.environ.get(f"RAY_TPU_{name.upper()}")
            if env is None:
                self._values[name] = default
            elif typ is bool:
                self._values[name] = env.lower() in ("1", "true", "yes")
            else:
                self._values[name] = typ(env)

    def __getattr__(self, name: str):
        try:
            return self.__dict__["_values"][name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value) -> None:
        if name.startswith("_"):
            super().__setattr__(name, value)
            return
        self.update({name: value})

    def update(self, overrides: Dict[str, Any]) -> None:
        for name, value in overrides.items():
            if name not in _FLAG_DEFS:
                raise ValueError(f"Unknown config flag: {name}")
            typ = _FLAG_DEFS[name][0]
            if typ is bool and isinstance(value, str):
                value = value.lower() in ("1", "true", "yes")
            self._values[name] = typ(value)

    def snapshot(self) -> Dict[str, Any]:
        return dict(self._values)


config = _Config()
