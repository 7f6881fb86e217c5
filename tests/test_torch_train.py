"""The port's Llama training path vs the JAX package on a tiny config:
``loss_fn`` values and gradients, the remat policies, and a 3-step
``build_train_step`` loss curve with its final params.

Weights are the JAX package's ``init_params`` (fp32 masters) carried with
``params_from_numpy(dtype=float32)``; tokens come from numpy. Tolerances:
- float32 compute: loss at rtol 1e-5, each gradient's max |error| within
  1e-4 of its max |value| (the same math; fp32 sums in another order,
  amplified a little by the backward's longer chains);
- bf16 compute (fp32 masters, each matmul's weight cast per use): loss at
  rtol 1e-2, gradients within 5e-2 of their max |value| (activations are
  rounded to bf16 between ops on both sides, after sums in another order);
- the remat policies against ``remat=False``: 1e-6 relative, since
  recomputation repeats the same ops on the same values;
- the 3-step curve in float32: losses at rtol 1e-5 (accum 1) and 1e-4
  (accum 2, whose microbatches differentiate with respect to bf16 copies
  of the params, so their bf16 gradients round after differently ordered
  sums), params within 2e-4 and 2e-3 (a fifth of one step's learning rate:
  Adam's update of a near-zero gradient is sensitive to its rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from dataclasses import replace

from ray_tpu.models import llama as jl
from ray_tpu.ops import optim as joptim
from ray_tpu.parallel import train_step as jts
from ray_tpu.parallel.mesh import MeshSpec
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import optim as toptim
from ray_tpu_torch.parallel import train_step as tts
from torch_parity import DTYPES, TINY, world_of_one  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32
torch.backends.cudnn.allow_tf32 = False


def _pair(dtype="f32", seed=0, **overrides):
    """(jax_cfg, jax_params, torch_cfg, torch_params) with fp32 masters."""
    jdt, tdt = DTYPES[dtype]
    kw = {**TINY, **overrides}
    jcfg = jl.LlamaConfig(dtype=jdt, **kw)
    tcfg = tl.LlamaConfig(dtype=tdt, **kw)
    jp = jl.init_params(jcfg, jax.random.key(seed))
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu", dtype=torch.float32)
    return jcfg, jp, tcfg, tp


def _tokens(b=2, s=17, seed=0):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"],
                                                (b, s)).astype(np.int32)


def _torch_value_and_grad(tp, tcfg, batch):
    leaves = toptim.tree_leaves(tp)
    for t in leaves:
        t.requires_grad_()
    loss = tl.loss_fn(tp, batch, tcfg)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return loss.detach(), grads


def _close_rel(got, want, tol, name=""):
    want = np.asarray(want, np.float32)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= tol * float(np.abs(want).max()), (name, err)


def _check_loss_and_grads(dtype, batch_np, **overrides):
    jcfg, jp, tcfg, tp = _pair(dtype, **overrides)
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    want_loss, want_g = jax.value_and_grad(jl.loss_fn)(jp, jbatch, jcfg)
    loss, grads = _torch_value_and_grad(tp, tcfg, tbatch)
    assert loss.dtype == torch.float32 and loss.shape == ()
    rtol, gtol = (1e-5, 1e-4) if dtype == "f32" else (1e-2, 5e-2)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=rtol)
    want_leaves = jax.tree.leaves(want_g)
    assert len(want_leaves) == len(grads)
    for w, g, p in zip(want_leaves, grads, toptim.tree_leaves(tp)):
        assert g.dtype == p.dtype == torch.float32
        _close_rel(g.numpy(), w, gtol, tuple(g.shape))


@pytest.mark.parametrize("impl,overrides", [
    ("xla", {}),
    ("flash", {}),
    ("chunked", {}),
    ("xla", dict(loss_chunk=8)),
    ("flash", dict(loss_chunk=8)),
    ("xla", dict(embed_via_matmul=True, embed_chunk=12)),
    ("flash", dict(embed_via_matmul=True, embed_chunk=16, loss_chunk=4)),
    ("xla", dict(fused_qkv=True, fused_mlp=True)),
    ("flash", dict(fused_qkv=True, fused_mlp=True, loss_chunk=8)),
], ids=lambda x: x if isinstance(x, str) else "-".join(sorted(x)) or "base")
def test_loss_and_grads_match_f32(impl, overrides):
    _check_loss_and_grads("f32", {"tokens": _tokens()},
                          attention_impl=impl, **overrides)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_loss_and_grads_match_bf16_compute(impl):
    """The training setting: fp32 masters, bf16 compute."""
    _check_loss_and_grads("bf16", {"tokens": _tokens(seed=1)},
                          attention_impl=impl, loss_chunk=8)


def test_loss_takes_inputs_and_targets():
    toks = _tokens(seed=2)
    _check_loss_and_grads("f32", {"inputs": toks[:, :-1],
                                  "targets": toks[:, 1:]})


@pytest.mark.parametrize("policy", ["full", "dots", "names"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_remat_policies_give_the_grads_of_no_remat(policy, impl):
    _, _, tcfg, tp = _pair("f32", attention_impl=impl, loss_chunk=8)
    batch = {"tokens": torch.from_numpy(_tokens(seed=3))}
    want_loss, want = _torch_value_and_grad(
        tp, replace(tcfg, remat=False), batch)
    loss, got = _torch_value_and_grad(
        tp, replace(tcfg, remat=True, remat_policy=policy), batch)
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=0)
    for g, w in zip(got, want):
        _close_rel(g.numpy(), w.numpy(), 1e-6, tuple(g.shape))


def test_unknown_remat_policy_raises():
    _, _, tcfg, tp = _pair("f32", remat_policy="offload")
    with pytest.raises(ValueError, match="remat_policy"):
        _torch_value_and_grad(tp, tcfg,
                              {"tokens": torch.from_numpy(_tokens())})


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_curve_matches_jax(accum_steps):
    """Three AdamW steps through both builders, on a 1-device mesh on the
    JAX side: per-step loss and grad norm, then the final params."""
    jcfg, jp, tcfg, tp = _pair("f32", attention_impl="flash", loss_chunk=8)
    toks = _tokens(b=4, seed=4)
    mesh = MeshSpec(fsdp=-1).build(jax.devices()[:1])
    jopt = joptim.adamw(1e-2, weight_decay=0.1)
    topt = toptim.adamw(1e-2, weight_decay=0.1)
    jstep = jts.build_train_step(lambda p, b: jl.loss_fn(p, b, jcfg), jopt,
                                 mesh, accum_steps=accum_steps)
    tstep = tts.build_train_step(lambda p, b: tl.loss_fn(p, b, tcfg), topt,
                                 accum_steps=accum_steps)
    js = jts.init_optimizer_state(jopt, jp)
    ts = tts.init_optimizer_state(topt, tp)
    ltol, ptol = (1e-5, 2e-4) if accum_steps == 1 else (1e-4, 2e-3)
    for _ in range(3):
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(toks)})
        tp, ts, tm = tstep(tp, ts, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=ltol)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=10 * ltol)
    for a, b in zip(jax.tree.leaves(jp), toptim.tree_leaves(tp)):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=ptol)


def test_eval_step_and_shard_batch():
    _, _, tcfg, tp = _pair("f32")
    batch = tts.shard_batch({"tokens": _tokens()}, device="cpu")
    assert batch["tokens"].device.type == "cpu"
    loss = tts.build_eval_step(lambda p, b: tl.loss_fn(p, b, tcfg))(tp,
                                                                    batch)
    assert not loss.requires_grad
    torch.testing.assert_close(loss, _torch_value_and_grad(tp, tcfg,
                                                           batch)[0])


@pytest.mark.parametrize("zero1", [False, True], ids=["mesh", "zero1"])
def test_one_rank_mesh_step_matches_jax_curve(world_of_one, zero1):
    """The mesh step (and the ZeRO-1 step) on a one-rank CPU mesh against
    the JAX builder on a 1-device mesh, as
    ``test_train_step_curve_matches_jax`` holds the mesh-less step: three
    AdamW steps, loss and grad norm each step, then the final params."""
    from ray_tpu_torch.parallel.mesh import MeshSpec as TMeshSpec

    jcfg, jp, tcfg, tp = _pair("f32", attention_impl="flash", loss_chunk=8)
    toks = _tokens(b=4, seed=4)
    jmesh = MeshSpec(fsdp=-1).build(jax.devices()[:1])
    tmesh = TMeshSpec(fsdp=-1).build(device_type="cpu")
    jopt = joptim.adamw(1e-2, weight_decay=0.1)
    topt = toptim.adamw(1e-2, weight_decay=0.1)
    jstep = jts.build_train_step(lambda p, b: jl.loss_fn(p, b, jcfg), jopt,
                                 jmesh)
    js = jts.init_optimizer_state(jopt, jp)
    lf = lambda p, b: tl.loss_fn(p, b, tcfg)  # noqa: E731
    if zero1:
        ts = tts.init_zero1_opt_state(topt, tp, tmesh)
        tstep = tts.build_zero1_train_step(lf, topt, tmesh, tp)
    else:
        tp = tts.init_sharded_params(lambda _: tp, tl.param_axes(tcfg),
                                     tmesh)
        ts = tts.init_optimizer_state(topt, tp)
        tstep = tts.build_train_step(lf, topt, tmesh)
    batch = tts.shard_batch({"tokens": toks}, tmesh)
    for _ in range(3):
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(toks)})
        tp, ts, tm = tstep(tp, ts, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    for a, b in zip(jax.tree.leaves(jp), toptim.tree_leaves(tp)):
        assert hasattr(b, "device_mesh") and b.dtype == torch.float32
        np.testing.assert_allclose(b.full_tensor().numpy(), np.asarray(a),
                                   rtol=0, atol=2e-4)


@pytest.mark.parametrize("fused", [False, True, "moe"])
def test_param_axes_and_flops_match_jax(fused):
    kw = (dict(moe_experts=8, moe_top_k=2) if fused == "moe"
          else dict(fused_qkv=fused, fused_mlp=fused))
    for name in ("debug", "1b", "7b"):
        jc = replace(jl.PRESETS[name], **kw)
        tc = replace(tl.PRESETS[name], **kw)
        assert tl.param_axes(tc) == jl.param_axes(jc)
        assert tc.num_params() == jc.num_params()
        assert tl.flops_per_token(tc, 2048) == jl.flops_per_token(jc, 2048)
    assert tl.param_axes() == jl.param_axes()


def test_init_params_fp32_masters_match_jax_tree():
    cfg = replace(tl.PRESETS["debug"], fused_qkv=True)
    tp = tl.init_params(cfg, device="cpu", dtype=torch.float32, seed=0)
    jp = jl.init_params(replace(jl.PRESETS["debug"], fused_qkv=True),
                        jax.random.key(0))
    assert jax.tree.structure(jax.tree.map(np.asarray, jp)) == \
        jax.tree.structure(jax.tree.map(lambda t: t.numpy(), tp))
    for leaf in toptim.tree_leaves(tp):
        assert leaf.dtype == torch.float32
    assert tl.init_params(cfg, device="cpu")["lm_head"].dtype == \
        torch.bfloat16
