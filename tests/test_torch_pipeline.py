"""The port's pipeline stage functions (``ray_tpu_torch.parallel.pipeline``)
and ``single_process_baseline`` (``ray_tpu_torch.train.pipeline_plane``)
against the JAX package's on the CPU, at the reference's tiny config
(``tests/test_pipeline_plane.py::_tiny_cfg``: vocab 64, dim 32, 4 layers).

Weights are the JAX package's ``init_params`` (fp32 masters) carried with
``params_from_numpy(dtype=float32)``; tokens come from numpy. Each side
chains its own stages, so a stage's input is its own side's previous
output. Tolerances, as in ``tests/test_torch_train.py``:
- float32 compute: losses at rtol 1e-5; each stage output, input
  gradient and param gradient within 1e-4 of its max |value| (the same
  math; fp32 sums in another order);
- bf16 compute (fp32 masters): losses at rtol 1e-2; stage outputs within
  2e-2 of their max |value| (activations round to bf16 between ops on
  both sides, after sums in another order); each gradient's L2 distance
  to the JAX bf16 gradient within twice the JAX bf16 gradient's own L2
  distance to the JAX float32 one (two bf16 paths that each carry that
  much rounding noise; at 4 layers it is 1.4-4.4% of the norm, more than
  a max-|value| bound of 5e-2 leaves to the small wk gradients);
- the 3-step ``single_process_baseline`` curve: losses at rtol 1e-5
  (float32) and 1e-2 (bf16); params within 0.2 x lr (float32: a fifth of
  one Adam step) and 3 x lr x steps (bf16: Adam's step on a near-zero
  gradient can take either sign, so the bound is the steps' reach, as
  ``RL_ADAM_BOUND`` in ``chip_smoke.py``).
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.parallel import pipeline as jpipe
from ray_tpu.train import pipeline_plane as jplane
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.parallel import pipeline as tpipe
from ray_tpu_torch.train import pipeline_plane as tplane
from torch_parity import DTYPES, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFG = dict(vocab_size=64, dim=32, n_layers=4, n_heads=4, n_kv_heads=2,
           mlp_dim=64, max_seq_len=64)
# (output / float32 gradient tolerance relative to max |value|, loss rtol)
TOL = {"f32": (1e-4, 1e-4, 1e-5), "bf16": (2e-2, None, 1e-2)}
LR = 1e-2


def _pair(dtype="f32", seed=0, **overrides):
    """(jax_cfg, jax_params, torch_cfg, torch_params) with fp32 masters."""
    jdt, tdt = DTYPES[dtype]
    kw = {**CFG, **overrides}
    jcfg = jl.LlamaConfig(dtype=jdt, **kw)
    tcfg = tl.LlamaConfig(dtype=tdt, **kw)
    jp = jl.init_params(jcfg, jax.random.key(seed))
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu", dtype=torch.float32)
    return jcfg, jp, tcfg, tp


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _close_rel(got, want, tol, name=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (name, err)


def _norm_rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _grads_close(got, want, want_f32, tol, name):
    """float32: max |error| within ``tol`` of max |value|; bf16
    (``want_f32`` given): the L2 noise-floor rule of the docstring."""
    if want_f32 is None:
        _close_rel(got, want, tol, name)
        return
    floor = _norm_rel(want, want_f32)
    assert _norm_rel(got, want) <= 2 * floor, (name, _norm_rel(got, want),
                                               floor)


def _tokens(b=2, s=17, seed=0):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (b, s)).astype(np.int32)


@pytest.mark.parametrize("n_layers,n_stages", [
    (4, 1), (4, 2), (4, 3), (4, 4), (7, 4), (22, 2), (22, 3), (22, 22)])
def test_stage_boundaries_match_jax(n_layers, n_stages):
    assert (tpipe.stage_boundaries(n_layers, n_stages)
            == jpipe.stage_boundaries(n_layers, n_stages))


@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_split_keys_and_shapes_match_jax(n_stages):
    jcfg, jp, tcfg, tp = _pair()
    want = jpipe.split_llama_stages(jp, jcfg, n_stages)
    got = tpipe.split_llama_stages(tp, tcfg, n_stages)
    assert len(got) == len(want) == n_stages
    for (gp, _gf), (wp, _wf) in zip(got, want):
        g, w = _flat(gp), _flat(wp)
        assert list(g) == list(w)
        for k in w:
            assert tuple(g[k].shape) == tuple(w[k].shape), k
            np.testing.assert_array_equal(_np(g[k]), _np(w[k]), err_msg=k)


@functools.lru_cache(maxsize=None)
def _chains(dtype, n_stages, seed=0, **overrides):
    """Both sides' stage chains on one microbatch: per stage its forward
    output (the loss on the last), then the backward from the last stage
    down: per stage its param gradients and input gradient."""
    jcfg, jp, tcfg, tp = _pair(dtype, seed=seed, **overrides)
    toks = _tokens(seed=seed)
    inputs, targets = toks[:, :-1], toks[:, 1:]
    sides = {}
    for side, cfg, params, pipe, asarray in (
            ("jax", jcfg, jp, jpipe, jnp.asarray),
            ("torch", tcfg, tp, tpipe, torch.from_numpy)):
        stages = [p for p, _f in pipe.split_llama_stages(params, cfg,
                                                         n_stages)]
        fns = [pipe.make_stage_train_fns(cfg, i, n_stages)
               for i in range(n_stages)]
        if side == "jax":
            fns = [(jax.jit(f), jax.jit(b)) for f, b in fns]
        x, tgt = asarray(inputs), asarray(targets)
        acts, outs = [x], []
        for i in range(n_stages - 1):
            outs.append(fns[i][0](stages[i], acts[i]))
            acts.append(outs[-1])
        outs.append(fns[-1][0](stages[-1], acts[-1], tgt))
        loss, gp, gx = fns[-1][1](stages[-1], acts[-1], tgt)
        g_params, g_xs = {n_stages - 1: gp}, {n_stages - 1: gx}
        for i in range(n_stages - 2, -1, -1):
            gp, gx = fns[i][1](stages[i], acts[i], gx)
            g_params[i], g_xs[i] = gp, gx
        sides[side] = dict(outs=outs, loss=loss, g_params=g_params,
                           g_xs=g_xs)
    return sides["jax"], sides["torch"]


@pytest.mark.parametrize("n_stages", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_stage_forward_backward_match_jax(dtype, n_stages):
    act_tol, grad_tol, loss_rtol = TOL[dtype]
    want, got = _chains(dtype, n_stages)
    want32 = _chains("f32", n_stages)[0] if dtype == "bf16" else None
    for i, (g, w) in enumerate(zip(got["outs"][:-1], want["outs"][:-1])):
        assert g.dtype == DTYPES[dtype][1]
        _close_rel(g, w, act_tol, f"stage {i} out")
    np.testing.assert_allclose(float(got["outs"][-1]),
                               float(want["outs"][-1]), rtol=loss_rtol)
    # The backward's loss is the forward's, computed again.
    assert float(got["loss"]) == float(got["outs"][-1])
    for i in range(n_stages):
        g, w = _flat(got["g_params"][i]), _flat(want["g_params"][i])
        w32 = _flat(want32["g_params"][i]) if want32 else {}
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == torch.float32
            _grads_close(g[k], w[k], w32.get(k), grad_tol, f"stage {i} {k}")
        if i == 0:
            assert got["g_xs"][0] is None and want["g_xs"][0] is None
        else:
            _grads_close(got["g_xs"][i], want["g_xs"][i],
                         want32["g_xs"][i] if want32 else None, grad_tol,
                         f"stage {i} g_x")


def test_flash_stages_match_jax_flash():
    """``attention_impl="flash"``: the JAX side runs its flash kernel as
    ``tests/test_torch_train.py`` runs it on the CPU, the port its plain
    version (the tensors lie on the CPU)."""
    act_tol, grad_tol, loss_rtol = TOL["f32"]
    want, got = _chains("f32", 2, seed=1, attention_impl="flash")
    _close_rel(got["outs"][0], want["outs"][0], act_tol, "stage 0 out")
    np.testing.assert_allclose(float(got["outs"][1]),
                               float(want["outs"][1]), rtol=loss_rtol)
    for i in range(2):
        g, w = _flat(got["g_params"][i]), _flat(want["g_params"][i])
        for k in w:
            _close_rel(g[k], w[k], grad_tol, f"stage {i} {k}")
    _close_rel(got["g_xs"][1], want["g_xs"][1], grad_tol, "g_x")


def test_embed_via_matmul_stage_matches_jax():
    act_tol, grad_tol, _ = TOL["f32"]
    want, got = _chains("f32", 2, seed=2, embed_via_matmul=True,
                        embed_chunk=8)
    _close_rel(got["outs"][0], want["outs"][0], act_tol, "stage 0 out")
    _close_rel(got["g_params"][0]["tok_embed"],
               want["g_params"][0]["tok_embed"], grad_tol, "tok_embed")


def test_remat_changes_no_stage_gradient():
    """The stage functions under ``remat=False`` give the gradients of
    ``remat=True`` (recomputation repeats the same ops on the same
    values), and the backward's recompute matches the forward."""
    _, _, tcfg, tp = _pair("f32", seed=3)
    toks = torch.from_numpy(_tokens(seed=3))
    stage = tpipe.split_llama_stages(tp, tcfg, 2)[1][0]
    x = tpipe.make_stage_train_fns(tcfg, 0, 2)[0](
        tpipe.split_llama_stages(tp, tcfg, 2)[0][0], toks[:, :-1])
    got, want = (tpipe.make_stage_train_fns(replace(tcfg, remat=r), 1, 2)[1](
        stage, x, toks[:, 1:]) for r in (True, False))
    assert float(got[0]) == float(want[0])
    for g, w in zip(_flat(got[1]).values(), _flat(want[1]).values()):
        _close_rel(g, w, 1e-6)
    _close_rel(got[2], want[2], 1e-6)


@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_make_stage_worker_matches_jax(n_stages):
    jcfg, jp, tcfg, tp = _pair("f32", seed=4)
    toks = _tokens(seed=4)[:, :-1]
    jstages = jpipe.split_llama_stages(jp, jcfg, n_stages)
    tstages = tpipe.split_llama_stages(tp, tcfg, n_stages)
    jx, tx = toks, toks
    for i in range(n_stages):
        jw = jpipe.make_stage_worker(jcfg, i, n_stages, jstages[i][0])
        tw = tpipe.make_stage_worker(tcfg, i, n_stages, tstages[i][0],
                                     device="cpu")
        x_in = tx
        jx, tx = jw(jx), tw(tx)
        assert isinstance(tx, torch.Tensor) and not tx.requires_grad
        _close_rel(tx, jx, TOL["f32"][0], f"stage {i}")
    # The last stage hands back fp32 logits; a second call runs the
    # function set up at the first, on the same values.
    assert tx.dtype == torch.float32 and tx.shape == (2, 16, 64)
    assert torch.equal(tw(x_in), tx)


def _steps(seed=0, n_steps=3, n_micro=4, batch=8, seq=17):
    rng = np.random.default_rng(seed)
    return [jplane.microbatches(
        {"tokens": rng.integers(0, CFG["vocab_size"],
                                (batch, seq)).astype(np.int32)}, n_micro)
        for _ in range(n_steps)]


def test_microbatches_match_jax():
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 64, (8, 17)).astype(np.int32)}
    got, want = tplane.microbatches(batch, 4), jplane.microbatches(batch, 4)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for k in ("inputs", "targets"):
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])
    with pytest.raises(ValueError, match="not divisible"):
        tplane.microbatches(batch, 3)


@pytest.mark.parametrize("n_stages", [None, 2])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_single_process_baseline_matches_jax(dtype, n_stages):
    jcfg, jp, tcfg, tp = _pair(dtype, seed=6)
    steps = _steps(seed=6)
    want, wparams = jplane.single_process_baseline(jcfg, jp, LR, steps,
                                                   n_stages=n_stages)
    before = {k: v.clone() for k, v in _flat(tp).items()}
    got, gparams = tplane.single_process_baseline(tcfg, tp, LR, steps,
                                                  n_stages=n_stages,
                                                  device="cpu")
    # The caller's params are left as they were.
    for k, v in _flat(tp).items():
        assert torch.equal(v, before[k]), k
    rtol, bound = ((1e-5, 0.2 * LR) if dtype == "f32"
                   else (1e-2, 3 * LR * len(steps)))
    np.testing.assert_allclose(got, want, rtol=rtol)
    assert len(got) == 3 and got[-1] < got[0]
    if n_stages is None:
        wparams, gparams = [wparams], [gparams]
    for g, w in zip(gparams, wparams):
        g, w = _flat(g), _flat(w)
        assert list(g) == list(w)
        for k in w:
            err = float(np.abs(_np(g[k]) - _np(w[k])).max())
            assert err <= bound, (k, err)
