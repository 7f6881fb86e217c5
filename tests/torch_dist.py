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
