"""The port's tune plane against the JAX package's on the CPU.

Search and schedulers are pure Python (numpy for PB2's GP): variants,
TPE suggestions, and ASHA / median-stopping / PBT / PB2 decisions on a
scripted result sequence must equal ``ray_tpu.tune``'s for the same seed,
with no timing involved. Then one user program
(``torch_train_program.tune_program``: a basic sweep, trial-error
isolation, ``Tuner.restore`` resuming errored trials from their
checkpoints, and gang trials of a 2-worker trainer) runs on ``ray_tpu``
and then on ``ray_tpu_torch``, each in a cluster of its own: the
``ResultGrid`` summaries must be equal."""

import pytest

import torch_train_program as prog
from ray_tpu import tune as jtune
from ray_tpu.tune import schedulers as jsched
from ray_tpu.tune import search as jsearch
from ray_tpu_torch import tune as ttune
from ray_tpu_torch.tune import schedulers as tsched
from ray_tpu_torch.tune import search as tsearch


def _space(search):
    return {"lr": search.grid_search([0.1, 0.01]),
            "wd": search.uniform(0, 1), "mom": search.loguniform(1e-3, 1),
            "layers": search.randint(1, 9), "act": search.choice(["a", "b"]),
            "fixed": 7}


@pytest.mark.parametrize("seed,n", [(0, 3), (5, 1), (11, 4)])
def test_generate_variants_match(seed, n):
    got = tsearch.generate_variants(_space(tsearch), n, seed)
    want = jsearch.generate_variants(_space(jsearch), n, seed)
    assert got == want and len(got) == 2 * n


def _tpe_run(tune, search, seed):
    tpe = tune.TPESearcher(seed=seed, n_startup_trials=6)
    tpe.set_search_properties("loss", "min", {
        "x": search.uniform(-1, 1), "y": search.loguniform(1e-3, 1),
        "k": search.randint(0, 5), "arm": search.choice(["a", "b", "c"])})
    out = []
    for i in range(24):
        cfg = tpe.suggest(f"t{i}")
        loss = ((cfg["x"] - 0.3) ** 2 + cfg["y"] + cfg["k"] * 0.01
                + {"a": 1.0, "b": 0.1, "c": 2.0}[cfg["arm"]])
        tpe.on_trial_complete(f"t{i}", {"loss": loss})
        out.append(cfg)
    return out


@pytest.mark.parametrize("seed", [0, 3])
def test_tpe_suggestions_match(seed):
    assert _tpe_run(ttune, tsearch, seed) == _tpe_run(jtune, jsearch, seed)


class _Trial:
    def __init__(self, tid, config):
        self.id, self.config = tid, config

    def __hash__(self):
        return hash(self.id)


def _scripted(make, seq):
    """Feed ``seq`` ((trial index, metrics) pairs) to a fresh scheduler;
    its decisions, and PBT's exploit targets and perturbed configs."""
    sched = make()
    trials = [_Trial(f"t{i}", {"lr": 10.0 ** -(i + 1)}) for i in range(4)]
    out = []
    for i, metrics in seq:
        decision = sched.on_result(trials[i], metrics)
        out.append(decision)
        if decision == "EXPLOIT":
            donor = sched.exploit_target(trials[i])
            out.append(donor.id if donor is not None else None)
            out.append(sched.perturb_config(trials[i].config))
    return out


def _curves(n_steps=8):
    seq = []
    for t in range(1, n_steps + 1):
        for i, q in enumerate((0.1, 0.3, 2.0, 5.0)):
            seq.append((i, {"loss": q + 1.0 / t, "acc": 10 * t / (q + 1),
                            "training_iteration": t}))
    return seq


SCHEDULERS = {
    "fifo": lambda m: m.FIFOScheduler(),
    "asha": lambda m: m.ASHAScheduler(metric="loss", mode="min", max_t=8,
                                      grace_period=1, reduction_factor=2),
    "median": lambda m: m.MedianStoppingRule(metric="loss", mode="min",
                                             grace_period=2,
                                             min_samples_required=3),
    "pbt": lambda m: m.PopulationBasedTraining(
        metric="acc", mode="max", perturbation_interval=2,
        hyperparam_mutations={"lr": [1e-3, 1e-2]}, seed=4),
    "pb2": lambda m: m.PB2(metric="acc", mode="max",
                           perturbation_interval=2,
                           hyperparam_bounds={"lr": (1e-5, 1e-1)},
                           log_scale=["lr"], seed=2),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_decisions_match(name):
    got = _scripted(lambda: SCHEDULERS[name](tsched), _curves())
    want = _scripted(lambda: SCHEDULERS[name](jsched), _curves())
    assert got == want
    if name in ("asha", "median"):
        assert "STOP" in got
    if name in ("pbt", "pb2"):
        assert "EXPLOIT" in got


def test_pb2_gp_perturbation_matches():
    """PB2's GP-UCB pick after enough observations (numpy on both
    sides)."""
    def run(mod):
        pb2 = mod.PB2(metric="score", mode="max", perturbation_interval=1,
                      hyperparam_bounds={"lr": (1e-4, 1e-1)},
                      log_scale=["lr"], seed=0)
        hi, lo = _Trial("hi", {"lr": 5e-2}), _Trial("lo", {"lr": 2e-4})
        s_hi = s_lo = 0.0
        for t in range(1, 8):
            s_hi += 10.0
            s_lo += 0.1
            pb2.on_result(hi, {"score": s_hi, "training_iteration": t})
            pb2.on_result(lo, {"score": s_lo, "training_iteration": t})
        return [pb2.perturb_config({"lr": 2e-4})["lr"] for _ in range(5)]

    got = run(tsched)
    assert got == run(jsched)
    assert sum(p > 3e-3 for p in got) >= 3, got


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import importlib

    tmp = str(tmp_path_factory.mktemp("tune"))
    out = {}
    for pkg in ("ray_tpu", "ray_tpu_torch"):
        rt = importlib.import_module(pkg)
        rt.init(num_cpus=4)
        try:
            out[pkg] = prog.tune_program(pkg, tmp)
        finally:
            rt.shutdown()
    return out


@pytest.mark.parametrize("key", ["basic", "errors", "restore", "gang",
                                 "cpus_back"])
def test_tuner_program_matches_jax(results, key):
    assert results["ray_tpu_torch"][key] == results["ray_tpu"][key]


def test_tuner_values(results):
    got = results["ray_tpu_torch"]
    assert got["basic"]["best"] == 3
    assert [r["metrics"]["score"] for r in got["basic"]["grid"]] == [3, 6, 9]
    assert got["errors"]["best"] == 3
    assert [r["error"] for r in got["errors"]["grid"]] == [
        None, ["RuntimeError", "bad", "trial"], None]
    assert [r["error"] is None for r in got["restore"]["first"]] == [
        True, True, False, False]
    assert all(r["error"] is None and r["metrics"]["step"] == 2
               for r in got["restore"]["resumed"])
    assert got["gang"]["best"] == 2.0
    assert got["gang"]["best_metrics"] == {
        "score": 6.0, "base": 7, "rank": 0, "training_iteration": 3}
    assert got["cpus_back"] == 4.0
