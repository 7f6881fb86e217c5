"""Multi-process runner of the port's mesh tests: N gloo ranks on the CPU,
the stand-in for the JAX package's virtual 8-device CPU mesh.

``run_ranks(fn, world, payload, tmp_path)`` spawns ``world`` processes
once, rendezvouses them through a ``FileStore`` under ``tmp_path`` (no
fixed port), and calls ``fn(rank, world, payload)`` in each, where
``fn`` is a function of this module (so the children import torch and
the port, never JAX or the test conftest). Each rank's return value is
pickled to a file and read back; a rank that raises fails the run with
its traceback, and a run past its deadline is killed and fails too.

The worker functions below run every case of one test module at one
world size and return ``{case: numpy arrays}``; the tests compare them
with the JAX package in the parent process.
"""

from __future__ import annotations

import pickle
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List

import numpy as np
import torch

_DEADLINE_S = 150.0


def _child(rank: int, fn_name: str, world: int, tmp: str) -> None:
    out = Path(tmp) / f"rank{rank}.pkl"
    try:
        import logging

        torch.set_num_threads(1)
        # DTensor warns on every Partial -> Replicate over two mesh dims.
        logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
        from ray_tpu_torch.parallel.mesh import init_distributed

        init_distributed(rank, world, f"file://{tmp}/store",
                         device_type="cpu", timeout_s=90)
        with open(Path(tmp) / "payload.pkl", "rb") as f:
            payload = pickle.load(f)
        result = {"ok": globals()[fn_name](rank, world, payload)}
    except BaseException:
        result = {"error": traceback.format_exc()}
    with open(out, "wb") as f:
        pickle.dump(result, f)
    import torch.distributed as dist

    if dist.is_initialized() and "error" not in result:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, payload: Any, tmp_path) -> List[Any]:
    """``fn(rank, world, payload)`` in ``world`` fresh processes; the list
    of their return values, by rank."""
    import torch.multiprocessing as mp

    tmp = Path(tmp_path) / f"{fn.__name__}_{world}"
    tmp.mkdir(parents=True, exist_ok=True)
    for stale in tmp.iterdir():  # a FileStore must start empty
        stale.unlink()
    with open(tmp / "payload.pkl", "wb") as f:
        pickle.dump(payload, f)
    ctx = mp.start_processes(_child, args=(fn.__name__, world, str(tmp)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + _DEADLINE_S
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} on {world} ranks passed "
                                   f"its {_DEADLINE_S:.0f} s deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    results = []
    for rank in range(world):
        with open(tmp / f"rank{rank}.pkl", "rb") as f:
            r = pickle.load(f)
        if "error" in r:
            raise RuntimeError(f"rank {rank} of {fn.__name__}:\n{r['error']}")
        results.append(r["ok"])
    return results


def _np(t) -> np.ndarray:
    if hasattr(t, "to_local"):
        t = t.to_local()
    return t.detach().float().cpu().numpy()


def _pl(placements) -> tuple:
    """Placements as stable names: ("Shard0", "Replicate", ...)."""
    return tuple(type(p).__name__ + str(getattr(p, "dim", ""))
                 for p in placements)


def _cpu_mesh(**spec):
    from ray_tpu_torch.parallel.mesh import MeshSpec

    return MeshSpec(**spec).build(device_type="cpu")


def _tensors(arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}


def loopback_ring(q, k, v, n: int, causal: bool = True) -> torch.Tensor:
    """The port's ``ring_flash_attention_local`` run for each of ``n``
    virtual ranks in this process, K/V rotated by indexing (its ``ring``
    argument) instead of collectives: the whole (B, S, H, D) output from
    global (B, S, H, D) q, k, v, differentiable in all three."""
    import torch.nn.functional as F

    from ray_tpu_torch.parallel.ring_attention import (
        ring_flash_attention_local)

    sl = q.shape[1] // n
    pad = (-q.shape[-1]) % 128
    shard = lambda t, r: t[:, r * sl:(r + 1) * sl]  # noqa: E731

    def ring_of(rank):
        src = [rank]

        def rotate_fn(kv):
            src[0] = (src[0] - 1) % n
            kv = torch.stack([shard(k, src[0]), shard(v, src[0])])
            return F.pad(kv, (0, pad)).transpose(2, 3)

        return rank, n, rotate_fn

    return torch.cat([ring_flash_attention_local(
        shard(q, r), shard(k, r), shard(v, r), None, causal=causal,
        ring=ring_of(r)) for r in range(n)], dim=1)


# ------------------------------------------------------------ mesh cases


def mesh_cases(rank: int, world: int, payload) -> Dict[str, Any]:
    """Mesh building, placements, ``constrain`` and ``shard_tree`` on an
    ``fsdp=world`` mesh."""
    from torch.distributed.tensor import Replicate, Shard

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import sharding as sh
    from ray_tpu_torch.parallel.mesh import AXES, decode_mesh

    mesh = _cpu_mesh(fsdp=world)
    out: Dict[str, Any] = {"names": tuple(mesh.mesh_dim_names),
                           "shape": tuple(mesh.shape)}
    assert out["names"] == AXES
    x = sh.distribute(torch.arange(12.0).reshape(3, 4), mesh,
                      [Replicate()] * 5)
    out["noop_outside_rules"] = sh.constrain(x, ("batch", None)) is x
    with sh.axis_rules(sh.compute_mesh(mesh)):
        y = sh.constrain(sh.on_mesh(x, sh.compute_mesh(mesh)),
                         ("batch", None))
        out["indivisible_placements"] = _pl(y.placements)
        z = sh.distribute(torch.arange(16.0).reshape(4, 4), mesh,
                          [Replicate()] * 5)
        z = sh.constrain(sh.on_mesh(z, sh.compute_mesh(mesh)),
                         ("batch", None))
        out["divisible_placements"] = _pl(z.placements)
        out["divisible_local"] = _np(z)
    cfg = llama.PRESETS["debug"]
    params = llama.params_from_numpy(payload["params"], cfg, device="cpu",
                                     dtype=torch.float32)
    placed = sh.shard_tree(params, sh.tree_shardings(
        mesh, llama.param_axes(cfg)))
    flat = llama._flat(placed)
    out["local_shapes"] = {k: tuple(v.to_local().shape)
                           for k, v in flat.items()}
    out["local_values"] = {k: _np(v) for k, v in flat.items()}
    out["placement_fsdp"] = {k: v.placements[1] == Shard(1)
                             for k, v in flat.items()}
    dmesh = decode_mesh((1, world), device_type="cpu")
    out["decode_names"] = tuple(dmesh.mesh_dim_names)
    return out


# ------------------------------------------------------------ ring cases


def ring_cases(rank: int, world: int, payload) -> Dict[str, Any]:
    """``ring_attention`` (both impls, causal and not) on a ``seq=world``
    mesh: each rank's output shard and q/k/v gradient shards of
    ``sum(out * w)`` with seq-sharded DTensor inputs, and the same through
    full plain tensors."""
    from ray_tpu_torch.parallel import sharding as sh
    from ray_tpu_torch.parallel.ring_attention import ring_attention

    mesh = _cpu_mesh(seq=world, fsdp=1)
    cmesh = sh.compute_mesh(mesh)
    t = _tensors(payload)
    spec = (("data", "fsdp"), "seq", "tensor")
    placements = sh.placements_for(cmesh, spec)
    out = {}
    for impl in ("xla", "flash"):
        for causal in (True, False):
            qkv = [sh.distribute(t[n], cmesh, placements).requires_grad_()
                   for n in ("q", "k", "v")]
            o = ring_attention(*qkv, mesh, causal=causal, impl=impl)
            w = sh.distribute(t["w"], cmesh, placements)
            (o.to_local() * w.to_local()).sum().backward()
            out[(impl, causal)] = {"out": _np(o), "dq": _np(qkv[0].grad),
                                   "dk": _np(qkv[1].grad),
                                   "dv": _np(qkv[2].grad)}
    q, k, v = (t[n].clone().requires_grad_() for n in ("q", "k", "v"))
    o = ring_attention(q, k, v, mesh, causal=True, impl="flash")
    (o * t["w"]).sum().backward()
    out["plain"] = {"out": _np(o), "dq": _np(q.grad), "dk": _np(k.grad),
                    "dv": _np(v.grad)}
    try:
        z = torch.zeros(1, 300 * world, 1, 16)
        ring_attention(z, z, z, mesh, impl="flash")
        out["block_error"] = None
    except ValueError as e:
        out["block_error"] = str(e)
    return out


# ----------------------------------------------------- moe/ulysses cases


def moe_ulysses_cases(rank: int, world: int, payload) -> Dict[str, Any]:
    """``ulysses_attention`` on a ``seq=world`` mesh (output and gradient
    shards, as ``ring_cases``), its divisibility error, and the MoE debug
    Llama trained on an ``expert=world`` mesh."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import optim
    from ray_tpu_torch.parallel import sharding as sh
    from ray_tpu_torch.parallel import train_step as ts
    from ray_tpu_torch.parallel.ulysses import ulysses_attention

    out: Dict[str, Any] = {}
    mesh = _cpu_mesh(seq=world, fsdp=1)
    cmesh = sh.compute_mesh(mesh)
    t = _tensors(payload["attn"])
    placements = sh.placements_for(cmesh, (None, "seq"))
    qkv = [sh.distribute(t[n], cmesh, placements).requires_grad_()
           for n in ("q", "k", "v")]
    o = ulysses_attention(*qkv, mesh, causal=True)
    w = sh.distribute(t["w"], cmesh, placements)
    (o.to_local() * w.to_local()).sum().backward()
    out["ulysses"] = {"out": _np(o), "dq": _np(qkv[0].grad),
                      "dk": _np(qkv[1].grad), "dv": _np(qkv[2].grad)}
    try:
        ulysses_attention(t["q"][:, :, :1], t["k"][:, :, :1],
                          t["v"][:, :, :1], mesh)
        out["heads_error"] = None
    except ValueError as e:
        out["heads_error"] = str(e)

    cfg = llama.LlamaConfig(**payload["moe_cfg"])
    emesh = _cpu_mesh(expert=world, fsdp=1)
    params = ts.shard_tree(
        llama.params_from_numpy(payload["moe_params"], cfg, device="cpu",
                                dtype=torch.float32),
        ts.tree_shardings(emesh, llama.param_axes(cfg)))
    out["expert_local_shape"] = tuple(
        params["layers"]["moe"]["w_gate"].to_local().shape)
    opt = optim.adamw(1e-3, weight_decay=1e-4)
    opt_state = ts.init_optimizer_state(opt, params)
    step = ts.build_train_step(lambda p, b: llama.loss_fn(p, b, cfg), opt,
                               emesh)
    batch = ts.shard_batch({"tokens": payload["moe_tokens"]}, emesh)
    losses = []
    for _ in range(4):
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
    out["moe_losses"] = losses
    return out


# ------------------------------------------------------ train-step cases


def _llama_setup(payload, mesh, cfg_kw=None):
    from dataclasses import replace

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import train_step as ts

    cfg = replace(llama.PRESETS["debug"], dtype=torch.float32,
                  **(cfg_kw or {}))
    params = ts.init_sharded_params(
        lambda _: llama.params_from_numpy(payload["params"], cfg,
                                          device="cpu", dtype=torch.float32),
        llama.param_axes(cfg), mesh)
    return cfg, params


def _curve(step, params, opt_state, batch, n):
    losses, norms = [], []
    for _ in range(n):
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, params


def train_cases(rank: int, world: int, payload) -> Dict[str, Any]:
    """The mesh train step on the debug Llama: 2-step curves on the mesh
    shapes of ``payload["meshes"]`` (accum 1 and 2), the ring loss on a
    seq mesh, ZeRO-1 (state bytes, curve), the ViT sharded loss and
    ``device_prefetch(mesh=...)``."""
    import numpy as np

    from ray_tpu_torch.data.ingest import device_prefetch
    from ray_tpu_torch.models import llama, vit
    from ray_tpu_torch.ops import optim
    from ray_tpu_torch.parallel import sharding as sh
    from ray_tpu_torch.parallel import train_step as ts

    out: Dict[str, Any] = {}
    opt = optim.adamw(1e-3, weight_decay=0.1)
    batch_np = {"tokens": payload["tokens"]}
    for name, spec, accum in payload["meshes"]:
        mesh = _cpu_mesh(**spec)
        cfg, params = _llama_setup(payload, mesh)
        step = ts.build_train_step(lambda p, b: llama.loss_fn(p, b, cfg),
                                   opt, mesh, accum_steps=accum)
        losses, norms, params = _curve(
            step, params, ts.init_optimizer_state(opt, params),
            ts.shard_batch(batch_np, mesh), 2)
        out[name] = {"losses": losses, "norms": norms,
                     "lm_head": _np(params["lm_head"].full_tensor())}

    if "seq" in payload:
        mesh = _cpu_mesh(seq=world, fsdp=1)
        cfg, params = _llama_setup(payload, mesh,
                                   dict(attention_impl="ring", remat=False))
        toks = payload["seq"]
        batch = ts.shard_batch({"inputs": toks[:, :-1],
                                "targets": toks[:, 1:]}, mesh)
        out["ring_loss"] = float(ts.build_eval_step(
            lambda p, b: llama.loss_fn(p, b, cfg), mesh)(params, batch))

    if payload.get("zero1"):
        mesh = _cpu_mesh(data=world, fsdp=1)
        cfg, _ = _llama_setup(payload, mesh)
        params = llama.params_from_numpy(payload["params"], cfg,
                                         device="cpu", dtype=torch.float32)
        plain_state = ts.init_optimizer_state(
            opt, ts._replicated_on(params, mesh))
        z1_state = ts.init_zero1_opt_state(opt, params, mesh)
        out["zero1_bytes"] = (ts.per_replica_state_bytes(plain_state),
                              ts.per_replica_state_bytes(z1_state))
        step = ts.build_zero1_train_step(
            lambda p, b: llama.loss_fn(p, b, cfg), opt, mesh, params)
        losses, norms, params = _curve(step, params, z1_state,
                                       ts.shard_batch(batch_np, mesh), 2)
        out["zero1"] = {"losses": losses, "norms": norms,
                        "params_placements": sorted({
                            _pl(p.placements) for p in
                            optim.tree_leaves(params)}),
                        "lm_head": _np(params["lm_head"].full_tensor())}

    if "vit" in payload:
        mesh = _cpu_mesh(data=2, tensor=2, fsdp=1)
        cfg = vit.PRESETS["debug"]
        params = ts.init_sharded_params(
            lambda _: vit.params_from_numpy(payload["vit"]["params"], cfg,
                                            device="cpu"),
            vit.param_axes(), mesh)
        vopt = optim.adamw(1e-3, weight_decay=1e-4)
        step = ts.build_train_step(lambda p, b: vit.loss_fn(p, b, cfg)[0],
                                   vopt, mesh)
        _, _, m = step(params, ts.init_optimizer_state(vopt, params),
                       ts.shard_batch(payload["vit"]["batch"], mesh))
        out["vit_loss"] = float(m["loss"])

    mesh = _cpu_mesh(fsdp=world)
    batches = [{"images": np.full((4, 2, 3), i, np.float32),
                "labels": np.arange(4) + i} for i in range(3)]
    got = list(device_prefetch(iter(batches), mesh=mesh))
    want = ts.shard_batch(batches[0], mesh)
    out["prefetch"] = {
        "placements": [_pl(b[k].placements) for b in got for k in sorted(b)],
        "want": [_pl(want[k].placements) for k in sorted(want)]
        * len(batches),
        "local": [_np(b["labels"]) for b in got],
        "spec": ts.batch_spec(3)}
    return out


# ------------------------------------------------- sharded decode cases


def _decode_logits(ld, params, cfg, prompts, half=6, pages=80, T=8):
    """Prefill, 4 decode steps, a suffix prefill, and a paged prefill with
    4 paged decode steps on ``prompts`` (B, S): the logits of each and
    the greedy tokens that fed the steps. Runs on local shards when the
    caller is inside ``local_shards``."""
    B, S = prompts.shape
    out = {}
    toks = torch.from_numpy(prompts).long()
    lg, cache = ld.prefill(params, toks, ld.init_cache(cfg, B, 64,
                                                       device="cpu"), cfg)
    out["prefill"] = lg
    steps = []
    for _ in range(4):
        tok = torch.argmax(lg, -1).to(torch.int32)
        steps.append(tok)
        lg, cache = ld.decode_step(params, cache, tok, cfg)
    out["decode"], out["decode_tokens"] = lg, torch.stack(steps)
    _, warm = ld.prefill(params, toks[:, :half],
                         ld.init_cache(cfg, B, 64, device="cpu"), cfg)
    out["suffix"], _ = ld.prefill_suffix(
        params, toks[:, half:], warm, cfg, torch.full((B,), half),
        torch.full((B,), S))
    W = pages // B
    bt = torch.arange(1, 1 + B * W, dtype=torch.int32).reshape(B, W)
    plg, pool = ld.paged_prefill(params, toks, ld.init_page_pool(
        cfg, pages, T, device="cpu"), bt, cfg)
    lens = torch.full((B,), S, dtype=torch.int32)
    steps = []
    for _ in range(4):
        tok = torch.argmax(plg, -1).to(torch.int32)
        steps.append(tok)
        plg, pool, lens = ld.paged_decode_step(params, pool, bt, lens, tok,
                                               cfg)
    out["paged"], out["paged_tokens"] = plg, torch.stack(steps)
    return {k: v.numpy() for k, v in out.items()}


def _engine_plan(payload):
    """(engine kwargs, schedule) of each engine case: the schedule maps a
    step index to the actions taken on rank 0 before that step."""
    p = payload["engine_prompts"]
    paged = dict(page_tokens=8, pool_pages=10, prefill_chunk_tokens=16,
                 prefix_pool_entries=8, prefix_match_min_tokens=8)
    sub = lambda name, n, temp=0.0, dl=None: ("submit", name, p[name], n,  # noqa: E731
                                             temp, dl)
    return {
        "contiguous": (dict(prefix_pool_entries=4, prefix_capacity=16,
                            prefix_match_min_tokens=8),
                       {0: [sub("src", 6), sub("a", 6), sub("b", 6)],
                        2: [sub("sharer", 6), sub("c", 5)]}),
        "paged": (dict(paged, device_sampler=True),
                  {0: [sub("long", 8), sub("src", 8),
                       sub("sampled", 8, 0.8)],
                   1: [sub("sharer", 8)],
                   3: [sub("a", 8), sub("b", 6), sub("c", 6)]}),
        "spec": (dict(page_tokens=8, pool_pages=40, spec_k=3,
                      prefill_bucket=16),
                 {0: [sub("src", 8), sub("a", 8), sub("b", 8)],
                  2: [sub("c", 6)]}),
        "cancel_deadline": (dict(page_tokens=8, pool_pages=40),
                            {0: [sub("src", 12), sub("a", 12),
                                 sub("b", 12, dl=1e-4)],
                             2: [sub("c", 12, dl=0.25)],
                             3: [("cancel", "a")],
                             4: [("sleep", 0.3)]}),
    }


def _drive_plan(eng, schedule, steps=200):
    """Rank 0's drive: the schedule's actions before their steps, then
    steps until every request ended. Returns {name: request}."""
    reqs = {}
    for i in range(steps):
        for act in schedule.get(i, []):
            if act[0] == "submit":
                _, name, prompt, n, temp, dl = act
                reqs[name] = eng.submit(prompt, max_new_tokens=n,
                                        temperature=temp, deadline_s=dl,
                                        request_id=name)
                if dl is not None and dl < 0.01:
                    time.sleep(0.01)  # expired before the next step
            elif act[0] == "cancel":
                assert eng.cancel(act[1])
            elif act[0] == "sleep":
                time.sleep(act[1])
        if i > max(schedule) and all(r.done.is_set() for r in reqs.values()):
            return reqs
        eng.step()
    raise AssertionError("requests did not finish")


def _ended(reqs):
    return {n: (r.status, list(r.output)) for n, r in reqs.items()}


def _mesh_engine_case(rank, make, schedule):
    """One engine on the mesh: rank 0 drives ``schedule``, the others
    follow in ``serve_forever`` until rank 0's stop. Every rank reports
    its requests (followers: their mirrors) and its lockstep counters."""
    eng = make()
    mirrors = []
    if rank:
        orig = eng._mirror
        eng._mirror = lambda wire: mirrors.append(orig(wire)) or mirrors[-1]
        eng.serve_forever()
        reqs = {r.request_id: r for r in mirrors}
    else:
        reqs = _drive_plan(eng, schedule)
        eng.shutdown()
    s = eng.stats()
    return eng, {"ended": _ended(reqs), "sent": eng._ctl.sent,
                 "steps": eng.steps, "chips": s["chips"],
                 "mesh_shape": s["mesh_shape"],
                 "counts": (s["cancelled"], s["deadline_exceeded"],
                            s.get("preempted", 0), s["prefill_chunks"],
                            s.get("prefix", {}).get("hits", 0),
                            s.get("spec", {}).get("accepted_tokens", 0))}


def sharded_decode_cases(rank: int, world: int, payload) -> Dict[str, Any]:
    """The decode mesh at ``world`` ranks: model-level logits on each mesh
    shape of ``payload["meshes"]`` (and of the GQA config) beside this
    rank's single-device logits, the local shapes of an indivisible
    config, and the engine cases on ``payload["engine_mesh"]``."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models import llama_decode as ld
    from ray_tpu_torch.parallel.mesh import decode_mesh
    from ray_tpu_torch.parallel.sharding import local_shards
    from ray_tpu_torch.serve.decode import DecodeEngine, LlamaDecodeDeployment

    out: Dict[str, Any] = {"logits": {}, "single": {}}
    prompts = payload["prompts"]
    models = {}
    for name, (cfg_kw, arrays) in payload["models"].items():
        cfg = llama.LlamaConfig(dtype=torch.float32, **cfg_kw)
        params = llama.params_from_numpy(arrays, cfg, device="cpu",
                                         dtype=torch.float32)
        models[name] = (cfg, params)
        if name == "draft":
            continue
        out["single"][name] = _decode_logits(ld, params, cfg, prompts)
        for shape in payload["meshes"]:
            mesh = decode_mesh(shape, device_type="cpu")
            sparams, sh = ld.shard_decode_state(params, cfg, mesh)
            with local_shards(sh["local"]):
                out["logits"][(name, shape)] = _decode_logits(
                    ld, sparams, cfg, prompts)
            if name == "gqa":
                out[("local_shapes", shape)] = {
                    k: tuple(v.shape)
                    for k, v in llama._flat(sparams).items()}
                out[("rules", shape)] = dict(sh["rules"])

    cfg, params = models["main"]
    if world == 4:
        # One row a batch rank: BLAS's matrix-vector path on the CPU.
        few = prompts[:4]
        mesh = decode_mesh((4, 1), device_type="cpu")
        sparams, sh = ld.shard_decode_state(params, cfg, mesh)
        with local_shards(sh["local"]):
            out["one_row"] = _decode_logits(ld, sparams, cfg, few, pages=40)
        out["one_row_single"] = _decode_logits(ld, params, cfg, few,
                                               pages=40)
    shape = payload["engine_mesh"]
    plans = _engine_plan(payload)
    dcfg, dparams = models["draft"]
    out["engines"] = {}
    for case, (kw, schedule) in plans.items():
        kw = dict(kw, slots=4, capacity=64, device="cpu")
        if case == "spec":
            kw.update(spec_draft_params=dparams, spec_draft_config=dcfg)

        def make(**mesh):
            eng = DecodeEngine(params, cfg, **mesh, **kw)
            if case == "spec":
                eng.warmup()  # every rank: the draft's and target's calls
            return eng

        if rank == 0:  # the single-device engine on the same schedule
            out["engines"][(case, "single")] = _ended(
                _drive_plan(make(), schedule))
        _, got = _mesh_engine_case(rank, lambda: make(mesh_shape=shape),
                                   schedule)
        out["engines"][(case, "mesh")] = got

    # The handoff: a prefill-only request captured on the mesh, adopted by
    # another mesh engine; the single-device capture and colocated stream
    # beside them.
    hk = dict(slots=4, capacity=64, page_tokens=8, pool_pages=40,
              device="cpu")
    prompt = payload["engine_prompts"]["src"]
    if rank == 0:
        single = DecodeEngine(params, cfg, **hk)
        r = single.submit(prompt, max_new_tokens=1, prefill_only=True)
        while not r.done.is_set():
            single.step()
        want = r.handoff
    meng = DecodeEngine(params, cfg, mesh_shape=shape, **hk)
    if rank == 0:
        r = meng.submit(prompt, max_new_tokens=1, prefill_only=True,
                        request_id="cap")
        while not r.done.is_set():
            meng.step()
        meng.shutdown()
        got = r.handoff
        out["capture_equal"] = (torch.equal(got["k"], want["k"])
                                and torch.equal(got["v"], want["v"])
                                and got["first_token"]
                                == want["first_token"])
        payload_adopt = {k: got[k] for k in ("k", "v", "committed_len",
                                             "first_token", "page_tokens")}
        colo = DecodeEngine(params, cfg, **hk)
        c = colo.submit(prompt, max_new_tokens=8)
        while not c.done.is_set():
            colo.step()
        out["colocated"] = list(c.output)
    else:
        meng.serve_forever()
    aeng = DecodeEngine(params, cfg, mesh_shape=shape, **hk)
    if rank == 0:
        a = aeng.submit(prompt, max_new_tokens=8, adopt=payload_adopt,
                        request_id="adopt")
        while not a.done.is_set():
            aeng.step()
        aeng.shutdown()
        out["adopted"] = list(a.output)
    else:
        aeng.serve_forever()
    out["adopted_pages"] = aeng.handoffs_adopted

    # Validation: slots the batch axis does not divide, a mesh the process
    # group does not match, requests to a follower.
    errors = {}
    for what, fn in (
            ("slots", lambda: DecodeEngine(params, cfg, slots=3,
                                           capacity=64, device="cpu",
                                           mesh_shape=(world, 1))),
            ("world", lambda: DecodeEngine(params, cfg, slots=4,
                                           capacity=64, device="cpu",
                                           mesh_shape=(1, 1)))):
        try:
            fn()
            errors[what] = None
        except ValueError as e:
            errors[what] = str(e)
    out["errors"] = errors

    # The deployment on the mesh: rank 0 serves a request; a follower
    # refuses one.
    dep = LlamaDecodeDeployment(config=cfg, slots=4, capacity=64, seed=0,
                                mesh_shape=shape, device="cpu")
    if rank == 0:
        out["deployment"] = dep({"tokens": [5, 9, 2],
                                 "max_new_tokens": 5})["tokens"]
        solo = LlamaDecodeDeployment(config=cfg, slots=4, capacity=64,
                                     seed=0, device="cpu")
        out["deployment_single"] = solo({"tokens": [5, 9, 2],
                                         "max_new_tokens": 5})["tokens"]
        solo.shutdown()
        out["deployment_stats"] = dep.replica_metrics()["mesh_shape"]
    else:
        try:
            dep({"tokens": [1, 2], "max_new_tokens": 2})
            out["follower_refuses"] = None
        except RuntimeError as e:
            out["follower_refuses"] = str(e)
    dep.shutdown(timeout_s=60.0)
    out["deployment_stopped"] = not dep._thread.is_alive()
    return out
