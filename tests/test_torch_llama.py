"""The port's Llama forward vs ``ray_tpu.models.llama.forward`` on a tiny
config, same weights (carried with ``params_from_numpy``).

float32 logits compare at rtol = atol = 1e-5 (same math, reordered fp32
sums). bfloat16 configs compare at atol = 5e-2 on logits of O(1): every
activation is rounded to bf16 (8 mantissa bits) between layers, on both
sides but after differently ordered sums."""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu_torch.models import llama as tl
from torch_parity import TINY, tiny_pair, world_of_one  # noqa: F401


def _tokens(b=2, s=16, seed=0):
    return np.random.default_rng(seed).integers(0, 61, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("impl,fused", [
    ("xla", dict()), ("chunked", dict()), ("flash", dict()),
    ("xla", dict(fused_qkv=True)), ("flash", dict(fused_qkv=True)),
    ("xla", dict(fused_mlp=True))])
def test_logits_match_f32(impl, fused):
    jcfg, jp, tcfg, tp = tiny_pair("f32", attention_impl=impl, **fused)
    toks = _tokens()
    want = np.asarray(jl.forward(jp, jnp.asarray(toks), jcfg))
    got = tl.forward(tp, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 16, 61)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_logits_match_bf16(impl):
    jcfg, jp, tcfg, tp = tiny_pair("bf16", attention_impl=impl)
    toks = _tokens(seed=1)
    want = np.asarray(jl.forward(jp, jnp.asarray(toks), jcfg))
    got = tl.forward(tp, torch.from_numpy(toks), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)


def test_params_carry_key_paths_and_dtypes():
    _, jp, tcfg, tp = tiny_pair("bf16", fused_qkv=True, fused_mlp=True)
    assert set(tp["layers"]) == set(jp["layers"])
    assert tp["layers"]["wqkv"].dtype == torch.bfloat16
    assert tp["layers"]["attn_norm"].dtype == torch.float32
    assert tuple(tp["layers"]["wqkv"].shape) == jp["layers"]["wqkv"].shape


def test_init_params_shapes_match_jax_tree():
    import jax

    cfg_j = jl.PRESETS["debug"]
    jp = jl.init_params(cfg_j, jax.random.key(0))
    tp = tl.init_params(tl.PRESETS["debug"], device="cpu", seed=0)
    for name, arr in jp["layers"].items():
        assert tuple(tp["layers"][name].shape) == arr.shape, name
    for name in ("tok_embed", "final_norm", "lm_head"):
        assert tuple(tp[name].shape) == jp[name].shape, name
    assert tp["tok_embed"].dtype == torch.bfloat16


def test_presets_match():
    for name, cfg in jl.PRESETS.items():
        t = tl.PRESETS[name]
        for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
                  "mlp_dim", "max_seq_len"):
            assert getattr(t, f) == getattr(cfg, f), (name, f)
    assert tl.config_for("7b").head_dim == 128


def test_ring_attention_needs_axis_rules_as_in_jax():
    jcfg, jp, tcfg, tp = tiny_pair("f32", attention_impl="ring")
    toks = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="axis_rules"):
        jl.forward(jp, jnp.asarray(toks), jcfg)
    with pytest.raises(ValueError, match="axis_rules"):
        tl.forward(tp, torch.from_numpy(toks), tcfg)


def test_ring_attention_on_a_one_rank_mesh_matches_jax(world_of_one):
    """``attention_impl='ring'`` under a one-rank mesh's axis rules: the
    ring of one hop equals the JAX dense loss (float32, rtol 1e-5)."""
    from ray_tpu_torch.parallel import train_step as tts
    from ray_tpu_torch.parallel.mesh import MeshSpec

    jcfg, jp, tcfg, tp = tiny_pair("f32", attention_impl="ring")
    toks = np.random.default_rng(0).integers(0, TINY["vocab_size"],
                                             (2, 17)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    want = float(jl.loss_fn(jp, {k: jnp.asarray(v) for k, v in
                                 batch.items()},
                            replace(jcfg, attention_impl="xla")))
    mesh = MeshSpec(seq=1, fsdp=1).build(device_type="cpu")
    params = tts.init_sharded_params(lambda _: tp, tl.param_axes(tcfg),
                                     mesh)
    got = tts.build_eval_step(lambda p, b: tl.loss_fn(p, b, tcfg), mesh)(
        params, tts.shard_batch(batch, mesh))
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
