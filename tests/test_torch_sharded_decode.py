"""The port's decode mesh (one serving replica over a ``(batch, model)``
mesh of gloo ranks, ``torch_dist``) against its own single-device path
and against the JAX package's single-chip programs.

Model level, on the JAX test's config (vocab 64, dim 32, 2 layers, 8 heads
on 8 kv heads, MLP 64), a GQA config whose 2 kv heads the 4-wide model
axis does not divide, and a GQA config with the fused ``wqkv`` and
``w_gate_up`` projections, float32, 8 prompts of 12 tokens: prefill, 4 decode
steps, a suffix prefill and a paged prefill with 4 paged decode steps on
meshes 1x2 and 2x1 (2 ranks) and 1x4, 2x2 and 4x1 (4 ranks). Every rank's
logits equal the port's single-device logits with ``torch.equal`` (the
JAX contract: no contraction dim is split), and the single-device logits
agree with the JAX single-chip ones within ``TOL`` (1e-4, float32 logits
differ by ~1e-6) under the margin rule.

Engine level, on a 1x2 mesh (2 ranks) and a 2x2 mesh (4 ranks): the
contiguous engine with prefix hits, the paged engine with chunked
prefill, preemption, a prefix hit and the device sampler, a speculative
engine with a noisy copy of the target as draft, a cancel and two expired
deadlines submitted on rank 0, a handoff captured on the mesh and adopted
by another mesh engine, the deployment: every stream and terminal status
equals the single-device engine's on the same schedule, on every rank,
and every rank exchanged the same number of control messages. Also the
validation (slots the batch axis does not divide, a mesh the process
group does not match, a request to a follower), ``stats()``'s chips and
mesh shape, ``decode_param_axes`` and the indivisible dims' layouts.

Each world size runs once for the module (``ranks``)."""

from dataclasses import replace
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.models import llama as jl
from ray_tpu.models import llama_decode as jld
from ray_tpu.parallel.sharding import decode_rules as j_decode_rules
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.parallel.sharding import decode_rules
import torch_dist

TOL = 1e-4
ONE_ROW_TOL = 2e-6
# The fused ``w_gate_up``'s gate and up are strided halves of one product;
# on the CPU, SiLU over a half narrower than its vector loop (16 columns
# on a 4-wide model axis here) takes the scalar path, which rounds apart
# from the vectorized one by an ulp.
FUSED_TOL = 2e-6
MAIN = dict(vocab_size=64, dim=32, n_layers=2, n_heads=8, n_kv_heads=8,
            mlp_dim=64, max_seq_len=128)
GQA = dict(vocab_size=61, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
           mlp_dim=64, max_seq_len=128)
FUSED = dict(GQA, vocab_size=64, fused_qkv=True, fused_mlp=True)
MESHES = {2: [(1, 2), (2, 1)], 4: [(1, 4), (2, 2), (4, 1)]}
ENGINE_MESH = {2: (1, 2), 4: (2, 2)}
CASES = ["prefill", "decode", "suffix", "paged"]
ENGINES = ["contiguous", "paged", "spec", "cancel_deadline"]


def _jcfg(kw):
    return jl.LlamaConfig(dtype=jnp.float32, **kw)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def setup():
    main = jl.init_params(_jcfg(MAIN), jax.random.key(0))
    gqa = jl.init_params(_jcfg(GQA), jax.random.key(1))
    fused = jl.init_params(_jcfg(FUSED), jax.random.key(4))
    noise = np.random.default_rng(2)
    draft = jax.tree.map(
        lambda a: np.asarray(a) * (1 + 0.05 * noise.standard_normal(
            a.shape).astype(np.float32)), main)
    prompts = np.random.RandomState(0).randint(1, 60, size=(8, 12)).astype(
        np.int32)
    rng = np.random.default_rng(3)
    src = rng.integers(1, 60, 16).tolist()
    engine_prompts = {"src": src, "sharer": src + rng.integers(
        1, 60, 4).tolist(), "a": [5, 9, 2, 6, 1], "b": [7, 3, 2],
        "c": rng.integers(1, 60, 9).tolist(),
        "long": rng.integers(1, 60, 30).tolist(),
        "sampled": rng.integers(1, 60, 6).tolist()}
    return {"models": {"main": (MAIN, _np_tree(main)),
                       "gqa": (GQA, _np_tree(gqa)),
                       "fused": (FUSED, _np_tree(fused)),
                       "draft": (MAIN, draft)},
            "jax": {"main": main, "gqa": gqa},
            "prompts": prompts, "engine_prompts": engine_prompts}


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_decode")
    base = {k: setup[k] for k in ("models", "prompts", "engine_prompts")}
    return {n: torch_dist.run_ranks(
        torch_dist.sharded_decode_cases, n,
        {**base, "meshes": MESHES[n], "engine_mesh": ENGINE_MESH[n]}, tmp)
        for n in (2, 4)}


def _jax_logits(cfg_kw, params, prompts, half=6, pages=80, T=8):
    """The JAX single-chip programs on the cases of ``_decode_logits``,
    and the top-2 margins behind each decode step's greedy token."""
    cfg = _jcfg(cfg_kw)
    B, S = prompts.shape
    toks = jnp.asarray(prompts)
    out = {}
    lg, cache = jld.prefill(params, toks, jld.init_cache(cfg, B, 64), cfg)
    out["prefill"] = np.asarray(lg)

    def steps(lg, step):
        toks, margins = [], []
        for _ in range(4):
            top2 = jnp.sort(lg, -1)[:, -2:]
            margins.append(np.asarray(top2[:, 1] - top2[:, 0]))
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
            toks.append(np.asarray(tok))
            lg = step(tok)
        return np.asarray(lg), np.stack(toks), np.stack(margins)

    def dstep(tok):
        nonlocal cache
        lg, cache = jld.decode_step(params, cache, tok, cfg)
        return lg

    out["decode"], out["decode_tokens"], out["decode_margins"] = steps(
        lg, dstep)
    _, warm = jld.prefill(params, toks[:, :half],
                          jld.init_cache(cfg, B, 64), cfg)
    slg, _ = jld.prefill_suffix(params, toks[:, half:], warm, cfg,
                                prefix_lens=jnp.full((B,), half, jnp.int32),
                                lengths=jnp.full((B,), S, jnp.int32))
    out["suffix"] = np.asarray(slg)
    W = pages // B
    bt = jnp.arange(1, 1 + B * W, dtype=jnp.int32).reshape(B, W)
    plg, pool = jld.paged_prefill(params, toks,
                                  jld.init_page_pool(cfg, pages, T), bt, cfg)
    lens = jnp.full((B,), S, jnp.int32)

    def pstep(tok):
        nonlocal pool, lens
        lg, pool, lens = jld.paged_decode_step(params, pool, bt, lens, tok,
                                               cfg)
        return lg

    out["paged"], out["paged_tokens"], out["paged_margins"] = steps(
        plg, pstep)
    return out


@pytest.fixture(scope="module")
def jax_refs(setup):
    return {name: _jax_logits(kw, setup["jax"][name], setup["prompts"])
            for name, kw in (("main", MAIN), ("gqa", GQA))}


def _mesh_ids():
    return [(n, name, shape) for n in (2, 4)
            for name in ("main", "gqa", "fused") for shape in MESHES[n]]


@pytest.mark.parametrize("n,name,shape", _mesh_ids(),
                         ids=lambda v: (f"{v[0]}x{v[1]}"
                                        if isinstance(v, tuple) else str(v)))
@pytest.mark.parametrize("case", CASES)
def test_sharded_logits_equal_single_device(ranks, n, name, shape, case):
    """Every rank's logits on the mesh are the single-device logits, bit
    for bit (the fused config within FUSED_TOL), and so are the greedy
    tokens that fed the decode steps."""
    for rank, res in enumerate(ranks[n]):
        got = res["logits"][(name, shape)]
        want = res["single"][name]
        if name == "fused":
            np.testing.assert_allclose(got[case], want[case], rtol=0,
                                       atol=FUSED_TOL)
        else:
            assert np.array_equal(got[case], want[case]), (rank, case)
        if case in ("decode", "paged"):
            key = f"{case}_tokens"
            assert np.array_equal(got[key], want[key]), rank


@pytest.mark.parametrize("case", CASES)
def test_one_row_a_batch_rank(ranks, case):
    """Four prompts on a 4x1 mesh put one row on each batch rank, and a
    one-row product takes BLAS's matrix-vector path on the CPU, which
    sums in another order than the batched product: there the logits
    agree with the single-device ones within ONE_ROW_TOL (float32
    rounding), and the greedy tokens are equal."""
    for res in ranks[4]:
        got, want = res["one_row"], res["one_row_single"]
        np.testing.assert_allclose(got[case], want[case], rtol=0,
                                   atol=ONE_ROW_TOL)
        if case in ("decode", "paged"):
            key = f"{case}_tokens"
            assert np.array_equal(got[key], want[key])


@pytest.mark.parametrize("name", ["main", "gqa"])
@pytest.mark.parametrize("case", CASES)
def test_single_device_logits_match_jax(ranks, jax_refs, name, case):
    """The port's logits (equal on every mesh, above) against the JAX
    single-chip programs: within TOL, the decode steps under the margin
    rule (a row whose JAX top-2 margin falls within TOL at a step stops
    being compared there)."""
    got, want = ranks[2][0]["single"][name], jax_refs[name]
    if case in ("prefill", "suffix"):
        np.testing.assert_allclose(got[case], want[case], rtol=0, atol=TOL)
        return
    toks, jtoks = got[f"{case}_tokens"], want[f"{case}_tokens"]
    margins = want[f"{case}_margins"]
    compared = 0
    for row in range(toks.shape[1]):
        low = np.nonzero(margins[:, row] <= TOL)[0]
        upto = low[0] if len(low) else toks.shape[0]
        assert np.array_equal(toks[:upto, row], jtoks[:upto, row]), row
        if not len(low):
            np.testing.assert_allclose(got[case][row], want[case][row],
                                       rtol=0, atol=TOL)
            compared += 1
    assert compared >= toks.shape[1] // 2


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (4, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_indivisible_dims_replicate_not_pad(ranks, shape):
    """The GQA config's 2 kv heads on a 4-wide model axis: heads, kv heads
    and the vocab of 61 replicate (whole on every rank, never padded) and
    the MLP still shards; on a 2-wide one (2x2) the heads shard too. The
    rules equal the JAX package's."""
    cfg = tl.LlamaConfig(**GQA)
    for res in ranks[4]:
        rules = res[("rules", shape)]
        sizes = {"batch": shape[0], "model": shape[1]}
        jmesh = SimpleNamespace(shape=sizes)  # what decode_rules reads
        assert rules == j_decode_rules(_jcfg(GQA), jmesh) == decode_rules(
            cfg, sizes)
        local = res[("local_shapes", shape)]
        model = shape[1]
        heads = cfg.n_heads if model == 4 else cfg.n_heads // model
        kv = cfg.n_kv_heads if model == 4 else cfg.n_kv_heads // model
        assert local["layers/wq"] == (2, 32, heads, cfg.head_dim)
        assert local["layers/wk"] == (2, 32, kv, cfg.head_dim)
        assert local["tok_embed"] == (61, 32)
        assert local["lm_head"] == (32, 61)
        assert local["layers/w_gate"] == (2, 32, 64 // model)
        assert local["layers/wo"] == (2, cfg.n_heads, cfg.head_dim, 32)
        assert local["layers/w_down"] == (2, 64, 32)


@pytest.mark.parametrize("name,shape", [("main", (2, 4)), ("gqa", (2, 4)),
                                        ("main", (8, 1))],
                         ids=lambda v: (f"{v[0]}x{v[1]}"
                                        if isinstance(v, tuple) else v))
def test_decode_shardings_specs_match_jax(name, shape):
    """The layouts of the decode state (contiguous cache, paged pool,
    prefix pool, the replicated ``length``) and of the params, as
    ``spec_for`` entries, equal the JAX ``decode_shardings``' specs on
    the same mesh shape."""
    from ray_tpu.parallel.mesh import decode_mesh as j_decode_mesh
    from ray_tpu_torch.models.llama_decode import decode_state_shardings
    from ray_tpu_torch.parallel.sharding import tree_shardings

    kw = MAIN if name == "main" else GQA
    jsh = jld.decode_shardings(_jcfg(kw), j_decode_mesh(shape))
    rules = decode_rules(tl.LlamaConfig(**kw), dict(zip(("batch", "model"),
                                                        shape)))
    assert rules == jsh["rules"]
    got = decode_state_shardings(None, rules)

    def spec(ns):
        return tuple(ns.spec)

    for part in ("cache", "pool", "prefix_pool"):
        for key, ns in jsh[part].items():
            assert got[part][key].spec == spec(ns), (part, key)
    assert got["replicated"].spec == spec(jsh["replicated"]) == ()
    params = tree_shardings(None, tl.decode_param_axes(tl.LlamaConfig(**kw)),
                            rules)
    flat_t = tl._flat(params)
    flat_j = tl._flat(jsh["params"])
    assert set(flat_t) == set(flat_j)
    for key in flat_j:
        assert flat_t[key].spec == spec(flat_j[key]), key


def test_decode_param_axes_replicates_contraction_operands():
    axes = tl.decode_param_axes(tl.LlamaConfig(**MAIN))
    assert axes == jl.decode_param_axes(_jcfg(MAIN))
    assert axes["layers"]["wo"] == ("layers", None, None, None)
    assert axes["layers"]["w_down"] == ("layers", None, None)
    assert axes["layers"]["wq"][2] == "heads"
    assert axes["lm_head"][1] == "vocab"
    fused = replace(tl.LlamaConfig(**MAIN), fused_qkv=True, fused_mlp=True)
    assert tl.decode_param_axes(fused) == jl.decode_param_axes(
        replace(_jcfg(MAIN), fused_qkv=True, fused_mlp=True))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", ENGINES)
def test_engine_on_mesh_matches_single_device(ranks, n, case):
    """Streams and terminal statuses equal the single-device engine's on
    the same schedule, on every rank; every rank exchanged as many control
    messages and ran as many steps as rank 0."""
    want = ranks[n][0]["engines"][(case, "single")]
    lead = ranks[n][0]["engines"][(case, "mesh")]
    assert lead["ended"] == want
    for res in ranks[n][1:]:
        got = res["engines"][(case, "mesh")]
        assert got["ended"] == want
        assert got["sent"] == lead["sent"] and got["steps"] == lead["steps"]
        assert got["counts"] == lead["counts"]
    cancelled, expired, preempted, chunks, hits, accepted = lead["counts"]
    if case == "contiguous":
        assert hits >= 1
    if case == "paged":
        assert preempted >= 1 and chunks >= 2 and hits >= 1
    if case == "spec":
        assert accepted >= 1
    if case == "cancel_deadline":
        assert (cancelled, expired) == (1, 2)
        assert want["a"][0] == "cancelled"
        assert want["b"][0] == want["c"][0] == "deadline_exceeded"
        assert want["src"][0] == "completed"


@pytest.mark.parametrize("n", [2, 4])
def test_stats_report_chips_and_mesh_shape(ranks, n):
    for res in ranks[n]:
        got = res["engines"][("paged", "mesh")]
        assert got["chips"] == n
        assert got["mesh_shape"] == list(ENGINE_MESH[n])
    assert ranks[n][0]["deployment_stats"] == list(ENGINE_MESH[n])


@pytest.mark.parametrize("n", [2, 4])
def test_handoff_capture_and_adopt_on_mesh(ranks, n):
    """Rank 0's capture gathers every kv head (equal to the single-device
    payload); another mesh engine adopts it and streams what the
    single-device colocated engine streams."""
    lead = ranks[n][0]
    assert lead["capture_equal"]
    assert lead["adopted"] == lead["colocated"]
    assert all(res["adopted_pages"] == 1 for res in ranks[n])


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_validation(ranks, n):
    """Slots the batch axis does not divide, a mesh of fewer ranks than
    the process group, and a request to a follower all raise."""
    for rank, res in enumerate(ranks[n]):
        assert "multiple of the mesh batch axis" in res["errors"]["slots"]
        assert "needs 1 ranks" in res["errors"]["world"]
        if rank:
            assert "rank 0" in res["follower_refuses"]
        assert res["deployment_stopped"]


@pytest.mark.parametrize("n", [2, 4])
def test_deployment_on_mesh_matches_single_device(ranks, n):
    lead = ranks[n][0]
    assert lead["deployment"] == lead["deployment_single"]
