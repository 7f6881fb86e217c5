"""One user program for the train and tune planes, run on ``ray_tpu`` and
then on ``ray_tpu_torch`` by ``tests/test_torch_train_plane.py``,
``tests/test_torch_tune.py`` and ``tests/test_torch_gang.py``.

Every function takes the package's name and imports it, so the same code
drives both runtimes (``JaxTrainer`` on one, ``TorchTrainer`` on the
other). This module imports neither package, nor JAX, nor torch at import:
the cluster's workers import it to run the train loops defined here. The
mesh loop (``llama_mesh_loop``) imports the port inside the worker.
"""

from __future__ import annotations

import importlib
import json
import os
import re
import tempfile
import time

TRAINERS = {"ray_tpu": "JaxTrainer", "ray_tpu_torch": "TorchTrainer"}


def _pkg(name: str):
    return importlib.import_module(name)


def _train(pkg: str):
    return importlib.import_module(f"{pkg}.train")


def _tune(pkg: str):
    return importlib.import_module(f"{pkg}.tune")


def trainer(pkg: str, loop, **kw):
    return getattr(_train(pkg), TRAINERS[pkg])(loop, **kw)


def _raised(fn):
    """The name of the exception ``fn`` raises, or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the class name is the result
        return type(e).__name__
    return None


def _summary(result) -> dict:
    """A trainer ``Result`` as plain values."""
    return {"error": result.error,
            "metrics": result.metrics,
            "history": [r["metrics"] for r in result.metrics_history],
            "checkpoint": (os.path.basename(result.checkpoint.path)
                           if result.checkpoint else None)}


# ------------------------------------------------------------ the loops


def reports_loop(config):
    train = _train(config["pkg"])
    for step in range(3):
        train.report({"step": step, "loss": 1.0 / (step + 1)})


def world_loop(config):
    train = _train(config["pkg"])
    train.report({"rank": train.get_world_rank(),
                  "world": train.get_world_size()})


def checkpoint_loop(config):
    train = _train(config["pkg"])
    for step in range(2):
        d = tempfile.mkdtemp()
        with open(os.path.join(d, "state.json"), "w") as f:
            json.dump({"step": step}, f)
        train.report({"step": step},
                     checkpoint=train.Checkpoint.from_directory(d))


def recovering_loop(config):
    """Crashes its worker process after reporting step 1's checkpoint,
    once; the retry resumes from that checkpoint."""
    train = _train(config["pkg"])
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        with open(os.path.join(ckpt.path, "state.json")) as f:
            start = json.load(f)["step"] + 1
    for step in range(start, 4):
        d = tempfile.mkdtemp()
        with open(os.path.join(d, "state.json"), "w") as f:
            json.dump({"step": step}, f)
        train.report({"step": step, "resumed_from": start},
                     checkpoint=train.Checkpoint.from_directory(d))
        if step == 1 and not os.path.exists(config["marker"]):
            open(config["marker"], "w").close()
            os._exit(1)  # hard-kill the worker process


def failing_loop(config):
    raise RuntimeError("always fails")


def collective_loop(config):
    """An all_reduce across the gang's process group, the group's record
    in the controller's registry, and the worker's local rank."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.core import multihost
    from ray_tpu_torch.train import session

    x = torch.full((4,), float(train.get_world_rank() + 1))
    dist.all_reduce(x)
    groups = multihost.registry_state()
    train.report({"sum": x.tolist(), "backend": dist.get_backend(),
                  "world": dist.get_world_size(), "pid": os.getpid(),
                  "local_rank": session.get_local_rank(),
                  "groups": [(g["owner"], g["num_hosts"], g["epoch"])
                             for g in groups.values()]})


def llama_mesh_loop(config):
    """The debug Llama in float32 on ``MeshSpec(fsdp=-1)`` over the gang's
    gloo group: 2 AdamW steps, a sharded checkpoint of params and state,
    a third step, then the third step again from the restored
    checkpoint."""
    from dataclasses import replace

    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import optim
    from ray_tpu_torch.parallel import train_step as ts
    from ray_tpu_torch.parallel.mesh import MeshSpec

    torch.set_num_threads(1)
    cfg = replace(llama.PRESETS["debug"], dtype=torch.float32)
    mesh = MeshSpec(fsdp=-1).build(device_type="cpu")
    params = ts.init_sharded_params(
        lambda _: llama.params_from_numpy(config["params"], cfg,
                                          device="cpu", dtype=torch.float32),
        llama.param_axes(cfg), mesh)
    opt = optim.adamw(1e-3, weight_decay=0.1)
    state = ts.init_optimizer_state(opt, params)
    step = ts.build_train_step(lambda p, b: llama.loss_fn(p, b, cfg), opt,
                               mesh)
    batch = ts.shard_batch({"tokens": config["tokens"]}, mesh)
    losses, norms = [], []
    for _ in range(2):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    ckpt = train.save_pytree(config["ckpt_dir"],
                             {"params": params, "opt": state}, step=2)
    leaves = optim.tree_leaves(params)
    placements = [[type(p).__name__ for p in v.placements] for v in leaves]
    _, _, m3 = step(params, state, batch)
    restored, meta = train.restore_pytree(ckpt, {"params": params,
                                                 "opt": state})
    same_placements = all(
        tuple(a.placements) == tuple(b.placements) for a, b in zip(
            optim.tree_leaves(restored["params"]), leaves))
    _, _, m3r = step(restored["params"], restored["opt"], batch)
    train.report({"losses": losses, "norms": norms,
                  "loss3": float(m3["loss"]),
                  "loss3_restored": float(m3r["loss"]),
                  "count_restored": restored["opt"].count,
                  "meta_step": meta["step"], "placements": placements,
                  "same_placements": same_placements,
                  "world": train.get_world_size()})


# ------------------------------------------------------------ programs


def train_program(pkg: str, tmp: str) -> dict:
    """The counterparts of ``tests/test_train.py``: single-worker reports,
    the world info of 3 workers, a checkpoint round trip, recovery from a
    crashed worker, an exhausted failure budget."""
    train = _train(pkg)
    out = {}
    out["reports"] = _summary(trainer(
        pkg, reports_loop, train_loop_config={"pkg": pkg},
        scaling_config=train.ScalingConfig(num_workers=1)).fit())
    out["world"] = _summary(trainer(
        pkg, world_loop, train_loop_config={"pkg": pkg},
        scaling_config=train.ScalingConfig(
            num_workers=3, resources_per_worker={"CPU": 1})).fit())
    storage = os.path.join(tmp, pkg, "storage")
    res = trainer(pkg, checkpoint_loop, train_loop_config={"pkg": pkg},
                  scaling_config=train.ScalingConfig(num_workers=1),
                  run_config=train.RunConfig(name="ckpt_test",
                                             storage_path=storage)).fit()
    with open(os.path.join(res.checkpoint.path, "state.json")) as f:
        out["checkpoint"] = {**_summary(res), "state": json.load(f)}
    out["recover"] = _summary(trainer(
        pkg, recovering_loop,
        train_loop_config={"pkg": pkg, "marker": os.path.join(
            tmp, pkg, "crashed_once")},
        scaling_config=train.ScalingConfig(num_workers=1),
        run_config=train.RunConfig(
            name="recover", storage_path=storage,
            failure_config=train.FailureConfig(max_failures=1))).fit())
    # Which of the killed attempt's reports reached the driver before the
    # kill depends on timing, on either runtime: keep the resumed ones.
    out["recover"]["history"] = [m for m in out["recover"]["history"]
                                 if m["resumed_from"] > 0]
    res = trainer(pkg, failing_loop, train_loop_config={"pkg": pkg},
                  scaling_config=train.ScalingConfig(num_workers=1),
                  run_config=train.RunConfig(
                      failure_config=train.FailureConfig(max_failures=1))
                  ).fit()
    out["exhausted"] = {"failed": res.error is not None,
                        "says": "always fails" in (res.error or ""),
                        "metrics": res.metrics}
    out["no_session"] = _raised(lambda: train.report({"x": 1}))
    out["no_session_rank"] = _raised(train.get_world_rank)
    rt = _pkg(pkg)
    out["cpus_back"] = _poll(lambda: rt.available_resources().get("CPU"),
                             rt.cluster_resources().get("CPU"))
    return out


def _grid(grid) -> list:
    """A ``ResultGrid`` as plain values, by config. A trial's error is its
    traceback's last line or the exception's repr, whichever reached the
    Tuner's poll first (on either runtime): keep the words of either."""
    rows = [{"config": {k: v for k, v in r.config.items() if k != "pkg"},
             "metrics": r.metrics,
             "error": (re.findall(r"\w+", r.error.strip().splitlines()[-1])
                       if r.error else None),
             "reports": len(r.metrics_history)} for r in grid]
    return sorted(rows, key=lambda r: json.dumps(r["config"],
                                                  sort_keys=True))


def scored_trainable(config):
    tune = _tune(config["pkg"])
    for step in range(3):
        tune.report({"score": config["x"] * (step + 1)})


def erroring_trainable(config):
    tune = _tune(config["pkg"])
    if config["x"] == 2:
        raise RuntimeError("bad trial")
    tune.report({"score": config["x"]})


def flaky_trainable(config):
    """Trials with flag >= 2 crash after checkpointing step 0; restored
    with ``resume_errored`` they resume from that checkpoint."""
    train = _train(config["pkg"])
    ckpt = train.get_checkpoint()
    start = 0
    if ckpt is not None:
        with open(os.path.join(ckpt.path, "step.txt")) as f:
            start = int(f.read()) + 1
    for step in range(start, 3):
        d = tempfile.mkdtemp()
        with open(os.path.join(d, "step.txt"), "w") as f:
            f.write(str(step))
        train.report({"loss": 10 - step, "step": step},
                     checkpoint=train.Checkpoint(d))
        if config["flag"] >= 2 and start == 0:
            raise RuntimeError("boom")


def gang_loop(config):
    train = _train(config["pkg"])
    assert train.get_world_size() == 2
    for step in range(3):
        train.report({"score": config["lr"] * (step + 1),
                      "base": config["base"],
                      "rank": train.get_world_rank()})


def tune_program(pkg: str, tmp: str) -> dict:
    """The counterparts of ``tests/test_tune.py``'s Tuner tests: basic,
    trial-error isolation, ``Tuner.restore`` resuming errored trials, and
    trainer gang trials."""
    tune = _tune(pkg)
    train = _train(pkg)
    out = {}
    grid = tune.Tuner(
        scored_trainable,
        param_space={"x": tune.grid_search([1, 2, 3]), "pkg": pkg},
        tune_config=tune.TuneConfig(metric="score", mode="max")).fit()
    best = grid.get_best_result()
    out["basic"] = {"grid": _grid(grid), "best": best.config["x"]}
    grid = tune.Tuner(
        erroring_trainable,
        param_space={"x": tune.grid_search([1, 2, 3]), "pkg": pkg},
        tune_config=tune.TuneConfig(metric="score", mode="max")).fit()
    out["errors"] = {"grid": _grid(grid),
                     "best": grid.get_best_result().config["x"]}
    storage = os.path.join(tmp, pkg, "tune")
    grid = tune.Tuner(
        flaky_trainable,
        param_space={"flag": tune.grid_search([0, 1, 2, 3]), "pkg": pkg},
        tune_config=tune.TuneConfig(metric="loss", mode="min"),
        storage_path=storage, name="restore_exp").fit()
    first = _grid(grid)
    restored = tune.Tuner.restore(os.path.join(storage, "restore_exp"),
                                  flaky_trainable, resume_errored=True)
    out["restore"] = {"first": first, "resumed": _grid(restored.fit())}
    gang = trainer(pkg, gang_loop,
                   train_loop_config={"pkg": pkg, "base": 7, "lr": 0.0},
                   scaling_config=train.ScalingConfig(num_workers=2),
                   run_config=train.RunConfig(
                       storage_path=os.path.join(tmp, pkg, "gang")))
    grid = tune.Tuner(
        gang, param_space={"lr": tune.grid_search([1.0, 2.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max")).fit()
    best = grid.get_best_result()
    out["gang"] = {"grid": _grid(grid), "best": best.config["lr"],
                   "best_metrics": best.metrics}
    rt = _pkg(pkg)
    out["cpus_back"] = _poll(lambda: rt.available_resources().get("CPU"),
                             rt.cluster_resources().get("CPU"))
    return out


def _poll(fn, want, timeout_s: float = 30.0):
    """``fn()`` once it returns ``want``, or its last value at the
    deadline."""
    deadline = time.monotonic() + timeout_s
    got = fn()
    while got != want and time.monotonic() < deadline:
        time.sleep(0.05)
        got = fn()
    return got
