"""The port's ViT (``ray_tpu_torch/models/vit.py``) against the JAX
package's on the ``debug`` preset: forward, loss and every gradient,
``pad_tokens_to``, the remat policies, a 3-step AdamW curve through both
train-step builders, and the shapes and counts of all three presets.

Weights are the JAX package's ``init_params`` (fp32 masters) with a random
non-zero ``head`` and ``head_bias`` from numpy (the JAX init zeroes the
head, which makes every logit the same and every gradient below the head
zero), carried with ``params_from_numpy``; images and labels come from
numpy. Tolerances:
- float32 compute: loss at rtol 1e-5, logits and each gradient's max
  |error| within 1e-4 of the reference's max |value| (the same math, fp32
  sums in another order);
- bf16 compute (fp32 masters): loss at rtol 1e-2, logits within 1e-2 and
  each gradient within 5e-2 of the max |value| of the JAX bf16 model's;
  each gradient also within 2e-2 of the max |value| of the JAX package's
  float32 gradient on the same weights. The port is closer to the float32
  math than the JAX bf16 path is: the latter's final-LayerNorm-bias
  gradient is 3.7% off the float32 one on this input (its cotangents
  are likely summed in bf16 by XLA on the CPU), the port's 0.3%;
- ``pad_tokens_to``: the JAX test's 2e-2 (logits) and 5e-2 (gradients) in
  bf16, and the float32 tolerances above in float32;
- the remat policies against ``remat=False``: 1e-6 relative (the same ops
  on the same values);
- the 3-step curve in float32: losses at rtol 1e-5 (accum 1) and 1e-4
  (accum 2, whose microbatches differentiate with respect to bf16 copies
  of the params), accuracy exactly, params within 2e-4 and 2e-3.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import vit as jvit
from ray_tpu.ops import optim as joptim
from ray_tpu.parallel import train_step as jts
from ray_tpu.parallel.mesh import MeshSpec
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.ops import optim as toptim
from ray_tpu_torch.parallel import train_step as tts
from torch_parity import DTYPES, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _pair(dtype="f32", seed=0, **overrides):
    """(jax_cfg, jax_params, torch_cfg, torch_params): the debug preset,
    fp32 masters, a random head on both sides."""
    jdt, tdt = DTYPES[dtype]
    jcfg = replace(jvit.PRESETS["debug"], dtype=jdt, **overrides)
    tcfg = replace(tvit.PRESETS["debug"], dtype=tdt, **overrides)
    jp = jvit.init_params(jcfg, jax.random.key(seed))
    rng = np.random.default_rng(100 + seed)
    jp["head"] = jnp.asarray(
        0.3 * rng.standard_normal(jp["head"].shape, dtype=np.float32))
    jp["head_bias"] = jnp.asarray(
        0.1 * rng.standard_normal(jp["head_bias"].shape, dtype=np.float32))
    tp = tvit.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    return jcfg, jp, tcfg, tp


def _batch(cfg, n=4, seed=0, label_dtype=np.int64):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal(
        (n, cfg.image_size, cfg.image_size, cfg.channels), dtype=np.float32)
    labels = rng.integers(0, cfg.num_classes, n).astype(label_dtype)
    return {"images": images, "labels": labels}


def _close_rel(got, want, tol, name=""):
    want = np.asarray(want, np.float32)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= tol * float(np.abs(want).max()), (name, err)


def _jax_grads(jp, jcfg, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, aux), g = jax.jit(jax.value_and_grad(
        lambda p, b: jvit.loss_fn(p, b, jcfg), has_aux=True))(jp, jb)
    return float(loss), float(aux["accuracy"]), jax.tree.leaves(g)


def _torch_grads(tp, tcfg, batch):
    leaves = toptim.tree_leaves(tp)
    for t in leaves:
        t.requires_grad_()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, aux = tvit.loss_fn(tp, tb, tcfg)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return (float(loss.detach()), float(aux["accuracy"]),
            [g.numpy() for g in grads])


def test_patchify_matches_jax():
    cfg = tvit.PRESETS["debug"]
    x = _batch(cfg)["images"]
    got = tvit.patchify(torch.from_numpy(x), cfg).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jvit.patchify(jnp.asarray(x), jvit.PRESETS["debug"])))


@pytest.mark.parametrize("dtype,remat", [("f32", False), ("bf16", True)])
def test_forward_loss_and_grads_match_jax(dtype, remat):
    """float32 without remat, and the training setting (bf16 compute,
    full remat) on both sides; the port's remat policies are held to its
    no-remat gradients below."""
    jcfg, jp, tcfg, tp = _pair(dtype, remat=remat)
    batch = _batch(tcfg, seed=1)
    want = np.asarray(jvit.forward(jp, jnp.asarray(batch["images"]), jcfg))
    with torch.no_grad():
        got = tvit.forward(tp, torch.from_numpy(batch["images"]), tcfg)
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    assert float(np.abs(want).std()) > 0.1     # the head is not zero
    loss, acc, grads = _torch_grads(tp, tcfg, batch)
    want_loss, want_acc, want_g = _jax_grads(jp, jcfg, batch)
    if dtype == "f32":
        _close_rel(got.numpy(), want, 1e-4, "logits")
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        gtol = 1e-4
    else:
        _close_rel(got.numpy(), want, 1e-2, "logits")
        np.testing.assert_allclose(loss, want_loss, rtol=1e-2)
        gtol = 5e-2
        # The float32 gradients on the same weights (see the docstring).
        jcfg32, jp32, _, _ = _pair("f32", remat=False)
        for g, w in zip(grads, _jax_grads(jp32, jcfg32, batch)[2]):
            _close_rel(g, w, 2e-2, g.shape)
    assert acc == want_acc
    assert len(grads) == len(want_g) == 16
    for g, w in zip(grads, want_g):
        assert g.shape == w.shape and g.dtype == np.float32
        assert np.abs(w).max() > 0
        _close_rel(g, w, gtol, g.shape)


def test_int32_labels_give_the_int64_loss():
    _, _, tcfg, tp = _pair()
    b64 = _batch(tcfg, seed=2)
    b32 = dict(b64, labels=b64["labels"].astype(np.int32))
    with torch.no_grad():
        l64 = tvit.loss_fn(tp, {k: torch.from_numpy(v)
                                for k, v in b64.items()}, tcfg)[0]
        l32 = tvit.loss_fn(tp, {k: torch.from_numpy(v)
                                for k, v in b32.items()}, tcfg)[0]
    assert float(l64) == float(l32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pad_tokens_to_is_exact(dtype):
    """The port of the JAX package's test: padded logits and gradients
    equal the unpadded ones (16 -> 32 tokens), and the padded port equals
    the padded JAX model."""
    jcfg, jp, tcfg, tp = _pair(dtype)
    tpad = replace(tcfg, pad_tokens_to=32)
    batch = _batch(tcfg, n=3, seed=3)
    images = torch.from_numpy(batch["images"])
    with torch.no_grad():
        base = tvit.forward(tp, images, tcfg).numpy()
        pad = tvit.forward(tp, images, tpad).numpy()
    ltol, gtol = (1e-4, 1e-4) if dtype == "f32" else (2e-2, 5e-2)
    _close_rel(pad, base, ltol, "padded logits")
    g_base = _torch_grads(tp, tcfg, batch)[2]
    g_pad = _torch_grads(tp, tpad, batch)[2]
    for a, b in zip(g_base, g_pad):
        _close_rel(b, a, gtol, a.shape)
    want = np.asarray(jvit.forward(jp, jnp.asarray(batch["images"]),
                                   replace(jcfg, pad_tokens_to=32)))
    _close_rel(pad, want, ltol, "padded logits against JAX")


@pytest.mark.parametrize("policy", [None, "full", "dots"])
def test_remat_policies_give_the_grads_of_no_remat(policy):
    _, _, tcfg, tp = _pair("f32")
    batch = _batch(tcfg, seed=4)
    want_loss, _, want = _torch_grads(tp, replace(tcfg, remat=False), batch)
    loss, _, got = _torch_grads(
        tp, replace(tcfg, remat=True, remat_policy=policy), batch)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    for g, w in zip(got, want):
        _close_rel(g, w, 1e-6, g.shape)


def test_dots_policy_saves_the_2d_products(monkeypatch):
    """Under "dots" the checkpoint keeps the outputs of the four 2-D
    products of each block (qkv, out, up, down: JAX's dots without batch
    dims) and recomputes the rest, attention's two batched products
    included."""
    from torch.utils.checkpoint import CheckpointPolicy

    seen = []
    policy = tllama._save_matmuls

    def record(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            seen.append((op, decision))
        return decision

    monkeypatch.setattr(tllama, "_save_matmuls", record)
    _, _, tcfg, tp = _pair("f32", remat_policy="dots")
    _torch_grads(tp, tcfg, _batch(tcfg, seed=5))
    saved = [op for op, d in seen if d == CheckpointPolicy.MUST_SAVE]
    assert len(saved) == 4 * tcfg.n_layers
    assert set(saved) == {torch.ops.aten.mm.default}
    bmm = [d for op, d in seen if op == torch.ops.aten.bmm.default]
    assert len(bmm) == 2 * tcfg.n_layers
    assert set(bmm) == {CheckpointPolicy.PREFER_RECOMPUTE}


def test_unknown_remat_policy_raises():
    _, _, tcfg, tp = _pair("f32", remat_policy="offload")
    with pytest.raises(ValueError, match="remat_policy"):
        _torch_grads(tp, tcfg, _batch(tcfg))


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_curve_matches_jax(accum_steps):
    """Three AdamW steps through both builders at the ViT-B/16 benchmark's
    learning rate (a 1-device mesh on the JAX side), with the accuracy as
    an extra metric: per-step loss, grad
    norm and accuracy, then the final params."""
    jcfg, jp, tcfg, tp = _pair("f32")
    batch = _batch(tcfg, n=8, seed=6)
    mesh = MeshSpec(fsdp=-1).build(jax.devices()[:1])
    jopt = joptim.adamw(3e-4, weight_decay=0.1)
    topt = toptim.adamw(3e-4, weight_decay=0.1)
    jstep = jts.build_train_step(
        lambda p, b: jvit.loss_fn(p, b, jcfg)[0], jopt, mesh,
        extra_metrics=lambda p, b: jvit.loss_fn(p, b, jcfg)[1],
        accum_steps=accum_steps)
    tstep = tts.build_train_step(
        lambda p, b: tvit.loss_fn(p, b, tcfg)[0], topt,
        extra_metrics=lambda p, b: tvit.loss_fn(p, b, tcfg)[1],
        accum_steps=accum_steps)
    js = jts.init_optimizer_state(jopt, jp)
    ts = tts.init_optimizer_state(topt, tp)
    ltol, ptol = (1e-5, 2e-4) if accum_steps == 1 else (1e-4, 2e-3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = []
    for _ in range(3):
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=ltol)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=10 * ltol)
        assert float(tm["accuracy"]) == float(jm["accuracy"])
        losses.append(float(tm["loss"]))
    assert losses[-1] < losses[0]
    for a, b in zip(jax.tree.leaves(jp), toptim.tree_leaves(tp)):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=ptol)


@pytest.mark.parametrize("name", ["debug", "vit_s16_cifar", "vit_b16"])
def test_axes_counts_and_flops_match_jax(name):
    jc, tc = jvit.PRESETS[name], tvit.PRESETS[name]
    for f in ("image_size", "patch_size", "channels", "num_classes", "dim",
              "n_layers", "n_heads", "mlp_dim", "dropout", "remat",
              "remat_policy", "pad_tokens_to", "num_patches", "head_dim",
              "patch_dim"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert tc.dtype == torch.bfloat16
    assert tvit.param_axes(tc) == jvit.param_axes(jc)
    assert tvit.num_params(tc) == jvit.num_params(jc)
    assert tvit.flops_per_image(tc) == jvit.flops_per_image(jc)
    if name == "vit_b16":
        assert tvit.num_params(tc) == 86_528_488
        assert round(tvit.flops_per_image(tc) / 1e11, 3) == 1.049


def test_init_params_shapes_and_scales():
    cfg = tvit.PRESETS["debug"]
    g = torch.Generator().manual_seed(0)
    tp = tvit.init_params(cfg, generator=g, device="cpu")
    jp = jvit.init_params(jvit.PRESETS["debug"], jax.random.key(0))
    for (a, b) in zip(jax.tree.leaves(jp), toptim.tree_leaves(tp)):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32
    assert toptim.tree_leaves(tp) and float(tp["head"].abs().max()) == 0.0
    assert torch.equal(tp["layers"]["ln1_scale"], torch.ones(2, 64))
    w = tp["layers"]["w_up"]
    assert float(w.abs().max()) <= 2 * cfg.dim ** -0.5
    # Truncated N(0, 1) on [-2, 2] has std 0.8796 before the scale.
    assert abs(float(w.std()) / cfg.dim ** -0.5 - 0.8796) < 0.03
    again = tvit.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    assert torch.equal(again["layers"]["wqkv"], tp["layers"]["wqkv"])
    bf = tvit.init_params(cfg, device="cpu", dtype=torch.bfloat16)
    assert bf["pos_embed"].dtype == torch.bfloat16


def test_params_from_numpy_checks_keys_and_shapes():
    cfg = tvit.PRESETS["debug"]
    tree = jax.tree.map(np.asarray, jvit.init_params(
        jvit.PRESETS["debug"], jax.random.key(0)))
    tp = tvit.params_from_numpy(tree, cfg, device="cpu",
                                dtype=torch.bfloat16)
    assert tp["layers"]["wqkv"].dtype == torch.bfloat16
    bad = dict(tree, layers=dict(tree["layers"], extra=np.zeros(3)))
    with pytest.raises(ValueError, match="keys"):
        tvit.params_from_numpy(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tvit.params_from_numpy(dict(tree, head=np.zeros((64, 11))), cfg,
                               device="cpu")
