"""Shared helpers of the ``test_torch_*`` parity tests: tiny configs built
the same way on both sides, weights carried from the JAX package into the
port, and the greedy-token margin rule.

Inputs and weights are made with numpy from a seed (or by the JAX
package's own ``init_params``) and handed to both sides, because
``jax.random`` and ``torch.Generator`` give different numbers."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu_torch.models import llama as tl

TINY = dict(vocab_size=61, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
            mlp_dim=64, max_seq_len=128)
# float32 comparisons mean float32 wherever these tests meet a card.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for a module of tiny models: they gain nothing
    from more, and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def world_of_one():
    """A one-rank gloo default process group (rendezvous in process) for
    one test's CPU meshes, torn down after it."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import init_distributed

    init_distributed(0, 1, device_type="cpu")
    yield
    dist.destroy_process_group()


def tiny_pair(dtype: str = "f32", seed: int = 0, **overrides):
    """(jax_cfg, jax_params, torch_cfg, torch_params) of one tiny model
    with identical weights; the port's params live on the CPU."""
    jdt, tdt = DTYPES[dtype]
    kw = {**TINY, **overrides}
    jcfg = jl.LlamaConfig(dtype=jdt, **kw)
    tcfg = tl.LlamaConfig(dtype=tdt, **kw)
    jp = jl.init_params(jcfg, jax.random.key(seed))
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    return jcfg, jp, tcfg, tp


def kv_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A port handoff payload tensor as the JAX engine's payload array,
    bit for bit: bf16 through a 16-bit integer view (numpy has no
    bfloat16; the JAX package's arrays use ml_dtypes')."""
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def kv_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A JAX handoff payload array as the port's CPU tensor, bit for
    bit (the inverse of ``kv_to_numpy``)."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16).copy()).view(
                torch.bfloat16)
    return torch.from_numpy(np.array(a))


def greedy_with_margins(tcfg, tp, prompt, max_new: int):
    """Solo greedy decode in the port, recording the top-2 logit margin
    behind every token: (tokens, margins)."""
    from ray_tpu_torch.models import llama_decode as td

    toks = torch.as_tensor(np.asarray(prompt, np.int64))[None]
    cache = td.init_cache(tcfg, 1, td.cache_bucket(toks.shape[1] + max_new),
                          device="cpu")
    logits, cache = td.prefill(tp, toks, cache, tcfg)
    out, margins = [], []
    for _ in range(max_new):
        top2 = torch.topk(logits[0], 2).values
        margins.append(float(top2[0] - top2[1]))
        tok = int(torch.argmax(logits[0]))
        out.append(tok)
        logits, cache = td.decode_step(
            tp, cache, torch.tensor([tok], dtype=torch.int32), tcfg)
    return out, margins


def assert_greedy_agrees(got, want, margins, tol: float) -> None:
    """Margin rule: tokens must match while the reference's top-2 margin
    exceeds ``tol``; at the first position whose margin is within ``tol``
    a disagreement is allowed and the comparison stops there (later
    tokens condition on different histories)."""
    assert len(got) == len(want), (got, want)
    for i, (g, w) in enumerate(zip(got, want)):
        if margins[i] <= tol:
            return
        assert g == w, (i, got, want, margins[i])
