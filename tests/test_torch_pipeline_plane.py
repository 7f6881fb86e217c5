"""The port's pipeline plane (``ray_tpu_torch.train.pipeline_plane``) on the
CPU: a counterpart of each of ``tests/test_pipeline_plane.py``'s 12 cases
(same names, settings and marks), on one module-scoped
``init(num_cpus=8)`` whose node advertises a virtual 4-host slice
(``RAY_TPU_VIRTUAL_SLICE=4x4/4``) with fault injection and the flight
recorder plumbed into every process, as the reference's ``pipe_cluster``.
Weights are the reference's (the JAX ``init_params`` at key 0, carried
with ``params_from_numpy``), so both runs start from the same state.

Where the reference differs:
- The two ZeRO-1 cases (``test_zero1_state_bytes_and_parity``,
  ``test_zero1_rules_namespaces_split_and_guarded``) exercise the mesh
  train step, not the plane; their counterparts are
  ``tests/test_torch_mesh_train.py::test_zero1_state_bytes_and_parity``
  and ``::test_zero1_rejects_a_model_rules_table``.
- The doctor's straggler case and the post-mortem case assert the port's
  doctor's verdicts (``ray_tpu_torch.doctor``) beside the evidence it
  reads (the ``pipeline_stage_idle_s`` gauges, the flight recorder's
  merged dump).
- The trace case reads the port's task events through the port's
  ``scripts.train_trace_summary`` / ``build_chrome_trace``.

Added: a tier-1 2-stage case whose losses equal the port's own 2-stage
chain exactly, lie within the reference's ``rtol=2e-4`` of the port's
full-model baseline, and within ``JAX_PLANE_RTOL`` of the JAX plane's
curve on the same weights and tokens (``tests/torch_pipeline_program.py``
runs the same program on both packages, the JAX one first, never both
up); and the registry's own cases (epoch bump, the stale-epoch fence,
``last_step`` as a max) against the JAX package's registry.
"""

import functools
import os
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
import torch_pipeline_program as prog
from ray_tpu_torch.core import coremetrics
from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.rpc_stubs import ControllerStub
from ray_tpu_torch.core.runtime import get_core_worker
from ray_tpu_torch.util import faultinject, metrics as um
from ray_tpu_torch.util.faultinject import Faults
from ray_tpu_torch.util.metrics import _Registry
from torch_parity import one_torch_thread  # noqa: F401

# The tiny config computes in bf16 over fp32 masters; the two packages
# round the activations to bf16 after sums in different orders, so their
# losses agree at the bf16 loss tolerance of tests/test_torch_train.py.
JAX_PLANE_RTOL = 1e-2
_ENV = ("RAY_TPU_VIRTUAL_SLICE", "RAY_TPU_FAULTINJECT_PATH",
        "RAY_TPU_FLIGHTREC_DIR")


@functools.lru_cache(maxsize=None)
def _weights():
    """The reference's weights: ``init_params(_tiny_cfg(), key(0))``."""
    import jax

    from ray_tpu.models import llama as jl

    return jax.tree.map(np.asarray,
                        jl.init_params(jl.LlamaConfig(**prog.TINY),
                                       jax.random.key(0)))


def _setup(seed=0, n_steps=3, n_micro=4, batch=8, seq=17):
    from ray_tpu_torch.train.pipeline_plane import microbatches

    cfg = prog.config("ray_tpu_torch")
    params = prog.params("ray_tpu_torch", _weights(), cfg)
    rng = np.random.default_rng(seed)
    steps = [microbatches(
        {"tokens": rng.integers(0, cfg.vocab_size,
                                (batch, seq)).astype(np.int32)},
        n_micro) for _ in range(n_steps)]
    return cfg, params, steps


@pytest.fixture(scope="module")
def jax_curve():
    """The JAX plane's 2-stage curve on the reference's weights and the
    tokens of ``_setup()``, under ``ray_tpu.init`` on a virtual 4-host
    slice, shut down before the port's cluster starts."""
    import ray_tpu
    from ray_tpu.train.pipeline_plane import microbatches

    rng = np.random.default_rng(0)
    steps = [microbatches({"tokens": rng.integers(
        0, 64, (8, 17)).astype(np.int32)}, 4) for _ in range(3)]
    saved = os.environ.get("RAY_TPU_VIRTUAL_SLICE")
    os.environ["RAY_TPU_VIRTUAL_SLICE"] = "4x4/4"
    try:
        ray_tpu.init(num_cpus=4)
        try:
            return prog.two_stage_curve("ray_tpu", _weights(), steps)
        finally:
            ray_tpu.shutdown()
    finally:
        if saved is None:
            os.environ.pop("RAY_TPU_VIRTUAL_SLICE", None)
        else:
            os.environ["RAY_TPU_VIRTUAL_SLICE"] = saved


@pytest.fixture(scope="module")
def faults_path(tmp_path_factory):
    return str(tmp_path_factory.mktemp("faults") / "pipe_faults.json")


@pytest.fixture(scope="module")
def pipe_cluster(jax_curve, tmp_path_factory, faults_path, one_torch_thread):
    """One cluster for the whole module: a virtual 4-host slice (4 chips
    per host) with fault injection AND the flight recorder plumbed into
    every process (env set BEFORE init so spawned stage workers inherit
    both; a per-run recorder dir keeps other runs' files out of the
    post-mortem). The driver runs one torch thread, and the plane hands
    its thread count to the stages."""
    fr_dir = str(tmp_path_factory.mktemp("flightrec"))
    saved = {k: os.environ.get(k) for k in _ENV}
    os.environ["RAY_TPU_VIRTUAL_SLICE"] = "4x4/4"
    os.environ["RAY_TPU_FAULTINJECT_PATH"] = faults_path
    os.environ["RAY_TPU_FLIGHTREC_DIR"] = fr_dir
    old_path = config.faultinject_path
    old_fr = config.flightrec_dir
    config.faultinject_path = faults_path
    config.flightrec_dir = fr_dir
    faultinject.reset_counters()
    core = rt.init(num_cpus=8)
    yield core
    rt.shutdown()
    config.faultinject_path = old_path
    config.flightrec_dir = old_fr
    faultinject.reset_counters()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _baseline(cfg, params, steps, n_stages=None):
    from ray_tpu_torch.train.pipeline_plane import single_process_baseline

    return single_process_baseline(cfg, params, 1e-2, steps,
                                   n_stages=n_stages, device="cpu")[0]


def _desc_p99(name):
    snap = {"local": _Registry.get().snapshot()}
    merged = um.merge_histograms(snap, "pipeline_desc_bytes")
    entry = merged.get((("pipeline", name),))
    assert entry and entry["count"] > 0
    return um.histogram_quantile(entry, 0.99), snap


# -------------------------------------------------- the registry alone


def test_registry_epoch_bump_keeps_last_step():
    """Re-registering an id bumps the epoch and keeps ``last_step`` (the
    resume point), as the JAX registry does."""
    from ray_tpu.core.pipereg import PipelineRegistry as JaxRegistry
    from ray_tpu_torch.core.pipereg import PipelineRegistry

    for reg in (PipelineRegistry(), JaxRegistry()):
        assert reg.register("p", 2, "g", "me") == {"epoch": 1,
                                                   "last_step": -1}
        assert reg.step_complete("p", 0, 1)["ok"]
        assert reg.register("p", 3, "g2") == {"epoch": 2, "last_step": 0}
        st = reg.state("p")
        assert (st["epoch"], st["num_stages"], st["group_id"],
                st["owner"]) == (2, 3, "g2", "me")
        assert reg.drop("p") and not reg.drop("p")
        assert reg.state("p") is None and reg.state() == {}


def test_registry_fences_a_stale_epoch():
    from ray_tpu.core.pipereg import PipelineRegistry as JaxRegistry
    from ray_tpu_torch.core.pipereg import PipelineRegistry

    for reg in (PipelineRegistry(), JaxRegistry()):
        assert reg.step_complete("nope", 0, 1) == {
            "ok": False, "reason": "unknown_pipeline"}
        reg.register("p", 2)
        reg.register("p", 2)
        assert reg.step_complete("p", 5, 1) == {
            "ok": False, "reason": "stale_epoch", "epoch": 2}
        assert reg.state("p")["last_step"] == -1
        assert reg.step_complete("p", 5, 2) == {"ok": True, "last_step": 5,
                                                "epoch": 2}


def test_registry_last_step_is_a_max():
    """Duplicate and re-ordered reports are idempotent: progress never
    moves backwards under one epoch."""
    from ray_tpu.core.pipereg import PipelineRegistry as JaxRegistry
    from ray_tpu_torch.core.pipereg import PipelineRegistry

    for reg in (PipelineRegistry(), JaxRegistry()):
        reg.register("p", 2)
        got = [reg.step_complete("p", s, 1)["last_step"]
               for s in (0, 2, 1, 2, 3)]
        assert got == [0, 2, 2, 2, 3]
        assert reg.state("p")["report_age_s"] is not None


# ---------------------------------------------- the plane against JAX


def test_two_stage_plane_matches_chain_baseline_and_jax(pipe_cluster,
                                                        jax_curve):
    """Two stages, window 2, 3 steps on the reference's weights: the
    losses equal the port's 2-stage chain exactly, lie within the
    reference's rtol 2e-4 of the port's full-model baseline and within
    ``JAX_PLANE_RTOL`` of the JAX plane's curve on the same tokens. RPCs
    carried descriptors (p99 within the budget), no ref is left, and the
    record is dropped at ``stop()``."""
    from ray_tpu_torch.train.pipeline_plane import PIPE_DESC_BYTE_BUDGET

    cfg, params, steps = _setup(n_steps=3)
    stage_base = _baseline(cfg, params, steps, n_stages=2)
    base = _baseline(cfg, params, steps)
    got = prog.two_stage_curve("ray_tpu_torch", _weights(), steps)
    assert got["losses"] == stage_base, (got["losses"], stage_base)
    np.testing.assert_allclose(got["losses"], base, rtol=2e-4)
    np.testing.assert_allclose(got["losses"], jax_curve["losses"],
                               rtol=JAX_PLANE_RTOL)
    assert got["losses"][-1] < got["losses"][0]
    p99, _snap = _desc_p99("parity-pipe")
    assert p99 is not None and p99 <= PIPE_DESC_BYTE_BUDGET
    for side in (got, jax_curve):
        assert side["ledger_refs"] == 0 and side["inflight"] == 0
        assert side["step"] == 3
        assert side["report"] == {"inflight_refs_dropped": 0,
                                  "ledger_refs": 0, "steps_completed": 3}
        assert side["record_after"] is None


# -------------------------------------------- schedule + loss parity


@pytest.mark.slow  # the reference's mark
def test_window_invariance_and_parity_2_stages(pipe_cluster):
    """Windows 1/2/4 all complete (no deadlock) and produce the SAME
    losses: overlap must never change the accumulation order. The curve
    is bit-exact vs the local chain of the same stage functions and
    matches the full-model baseline within relative tolerance.
    Descriptors stay within budget."""
    from ray_tpu_torch.train.pipeline_plane import (PIPE_DESC_BYTE_BUDGET,
                                                    PipelinePlane)

    cfg, params, steps = _setup(n_steps=3)
    base = _baseline(cfg, params, steps)
    stage_base = _baseline(cfg, params, steps, n_stages=2)
    plane = PipelinePlane(cfg, params, n_stages=2, n_microbatches=4,
                          lr=1e-2, window=2, name="win-pipe",
                          device="cpu").start()
    try:
        got = []
        for window, mbs in zip((1, 2, 4), steps):
            plane.window = window
            got.append(plane.train_step(mbs))
        assert got == stage_base, (got, stage_base)
        np.testing.assert_allclose(got, base, rtol=2e-4)
        p99, snap = _desc_p99("win-pipe")
        assert p99 is not None and p99 <= PIPE_DESC_BYTE_BUDGET
        # ...and the shared core_summary read path surfaces the plane.
        summary = coremetrics.core_summary(snap)
        assert summary["pipeline"]["desc_bytes"]["count"] > 0
        st = plane.stats()
        assert st["ledger_refs"] == 0 and st["inflight_microbatches"] == 0
    finally:
        report = plane.stop()
    assert report["inflight_refs_dropped"] == 0
    assert report["ledger_refs"] == 0
    assert plane.registry_state() is None  # record dropped


@pytest.mark.slow  # the reference's mark
def test_loss_parity_4_stages(pipe_cluster):
    """Four 1-layer stages, 8 microbatches: bit-exact vs the local
    4-stage chain, tolerance-parity vs the full model."""
    from ray_tpu_torch.train.pipeline_plane import PipelinePlane

    cfg, params, steps = _setup(n_steps=2, n_micro=8, batch=8)
    base = _baseline(cfg, params, steps)
    stage_base = _baseline(cfg, params, steps, n_stages=4)
    plane = PipelinePlane(cfg, params, n_stages=4, n_microbatches=8,
                          lr=1e-2, window=4, name="four-pipe",
                          device="cpu").start()
    try:
        got = plane.run(steps)
    finally:
        plane.stop()
    assert got == stage_base, (got, stage_base)
    np.testing.assert_allclose(got, base, rtol=2e-4)


def test_one_stage_degenerate_bitexact(pipe_cluster):
    """The 1-stage pipeline is the degenerate config: distribution must
    add NOTHING — bit-exact against the local run of the same stage
    function."""
    from ray_tpu_torch.train.pipeline_plane import PipelinePlane

    cfg, params, steps = _setup(n_steps=2)
    stage_base = _baseline(cfg, params, steps, n_stages=1)
    plane = PipelinePlane(cfg, params, n_stages=1, n_microbatches=4,
                          lr=1e-2, name="one-pipe", device="cpu").start()
    try:
        got = plane.run(steps)
    finally:
        plane.stop()
    assert got == stage_base, (got, stage_base)


# ------------------------------------- stage death + gang reconcile


def _kill_then_step(plane, faults_path, rule_site, rule_id, mbs):
    with Faults(faults_path) as f:
        rule = f.add(rule_site, "die", once_global=True, rule_id=rule_id)
        deadline = time.monotonic() + 30.0
        while not f.marker_fired(rule) and time.monotonic() < deadline:
            time.sleep(0.02)
        assert f.marker_fired(rule)
        return plane.train_step(mbs)


@pytest.mark.chaos
def test_stage_sigkill_reconciles_and_resumes(pipe_cluster, faults_path):
    """SIGKILL one stage mid-run (faultinject die at its member beat
    site): the WHOLE gang re-forms under epoch+1, the interrupted step
    replays from the driver snapshot, and the final loss curve is
    IDENTICAL to an uninterrupted run. Zero refs leak; the deposed
    incarnation's step reports are fenced."""
    from ray_tpu_torch.train.pipeline_plane import PipelinePlane

    cfg, params, steps = _setup(seed=7, n_steps=3)
    stage_base = _baseline(cfg, params, steps, n_stages=2)
    plane = PipelinePlane(cfg, params, n_stages=2, n_microbatches=4,
                          lr=1e-2, window=2, name="kill-pipe",
                          device="cpu").start()
    try:
        got = []
        for i, mbs in enumerate(steps):
            if i == 1:
                got.append(_kill_then_step(
                    plane, faults_path,
                    "multihost.member.kill-pipe-gang.host-1.beat",
                    "kill-s1", mbs))
            else:
                got.append(plane.train_step(mbs))
        assert got == stage_base, (got, stage_base)
        st = plane.stats()
        assert st["gang_epoch"] == 2          # whole-gang restart
        assert st["epoch"] == 2               # pipeline re-registered
        assert st["ledger_refs"] == 0
        assert st["group"]["restarts"] == 1
        # Controller record: resumed progress, deposed epoch fenced.
        reg = plane.registry_state()
        assert reg["epoch"] == 2 and reg["last_step"] == 2
        stub = ControllerStub(get_core_worker().controller)
        stale = stub.pipe_step_complete("kill-pipe", 99, 1)
        assert stale == {"ok": False, "reason": "stale_epoch",
                         "epoch": 2}
        assert reg["last_step"] == plane.registry_state()["last_step"]
    finally:
        report = plane.stop()
    assert report["ledger_refs"] == 0


# -------------------------------- pipeline-stall: the doctor's evidence


def _stage_idle(name):
    """{stage: idle seconds} of one pipeline, off the driver's registry
    (what the doctor's pipeline-stall signature reads)."""
    return {row["tags"]["stage"]: row["value"]
            for row in _Registry.get().snapshot()
            if row["name"] == "pipeline_stage_idle_s"
            and row["tags"].get("pipeline") == name}


def _agg(source="n1/node/pid1"):
    """The driver's registry as a one-source cluster aggregation (the
    doctor's input)."""
    return {source: _Registry.get().snapshot()}


def _split_stall(idle, floor=0.5, ratio=0.3):
    """The doctor's rule: (busy, starved) once the most idle stage passed
    ``floor``; a stage within ``ratio`` of that is busy."""
    mx = max(idle.values())
    if mx < floor:
        return set(), set()
    busy = {s for s, v in idle.items() if v <= ratio * mx}
    return busy, set(idle) - busy


@pytest.mark.slow  # the reference's marks
@pytest.mark.chaos
def test_doctor_names_pipeline_stall_straggler(pipe_cluster, faults_path):
    """Delay stage 1's forward (faultinject at the pipeline.stage site)
    mid-step: stage 1 stays busy while stage 0 idles through the whole
    window in both gauge snapshots, the doctor names s1 as the straggler
    (``pipeline-stall``), and the flight recorder holds the injected delay
    at s1's forward site. The delay elapses, the step completes, and the
    divergence and the signature clear."""
    from ray_tpu_torch import doctor
    from ray_tpu_torch.train.pipeline_plane import PipelinePlane
    from ray_tpu_torch.util import flightrec

    cfg, params, steps = _setup(n_steps=1)
    plane = PipelinePlane(cfg, params, n_stages=2, n_microbatches=4,
                          lr=1e-2, window=2, name="stall-pipe",
                          device="cpu").start()
    result, errs = [], []

    def run_step():
        try:
            result.append(plane.train_step(steps[0]))
        except Exception as e:  # surfaced via errs below
            errs.append(e)

    try:
        with Faults(faults_path) as f:
            f.add("pipeline.stage.stall-pipe.1.fwd", "delay",
                  delay_s=3.0)
            t = threading.Thread(target=run_step, daemon=True)
            t.start()
            time.sleep(1.2)
            before, agg_before = _stage_idle("stall-pipe"), _agg()
            time.sleep(1.0)
            after, agg_after = _stage_idle("stall-pipe"), _agg()
        busy_b, idle_b = _split_stall(before)
        busy_a, idle_a = _split_stall(after)
        assert busy_a & busy_b == {"s1"}, (before, after)
        assert idle_a & idle_b == {"s0"}, (before, after)
        findings = doctor.diagnose(agg_before, agg_after, 1.0)
        stalls = [x for x in findings
                  if x["signature"] == "pipeline-stall"
                  and "stall-pipe" in x["source"]]
        assert stalls, findings
        assert stalls[0]["severity"] == "critical"
        assert "s1" in stalls[0]["evidence"]["stragglers"]
        assert "s0" in stalls[0]["evidence"]["starved"]
        assert "s1" in stalls[0]["summary"]
        t.join(timeout=60.0)
        assert not t.is_alive() and not errs, errs
        assert len(result) == 1
        # Stall over: no stage is a straggler any more.
        assert _split_stall(_stage_idle("stall-pipe")) == (set(), set())
        snap = _agg()
        assert [x for x in doctor.diagnose(snap, snap, 1.0)
                if x["signature"] == "pipeline-stall"] == []
        dump = flightrec.cluster_dump()
        events = [e for src in dump.values() for e in src["events"]]
        assert any(e.get("ev") == "fault.fired"
                   and e.get("site") == "pipeline.stage.stall-pipe.1.fwd"
                   for e in events)
        assert any(e.get("ev") == "pipe.step.commit"
                   and e.get("pipeline") == "stall-pipe" for e in events)
    finally:
        plane.stop()


# --------------------------------- transient disruptions (no reconcile)


@pytest.mark.chaos
def test_transient_stage_error_replay_does_not_double_accumulate(
        pipe_cluster, faults_path):
    """One stage RPC fails transiently mid-step (injected error at the
    stage-forward site; every member still answers ping, so no gang
    reconcile happens) and the step replays on the SURVIVING gang:
    ``begin_step`` resets per-step stage state, so the full curve stays
    bit-exact and the gang never restarts."""
    from ray_tpu_torch.train.pipeline_plane import PipelinePlane

    cfg, params, steps = _setup(seed=11, n_steps=3)
    stage_base = _baseline(cfg, params, steps, n_stages=2)
    plane = PipelinePlane(cfg, params, n_stages=2, n_microbatches=4,
                          lr=1e-2, window=2, name="flake-pipe",
                          device="cpu").start()
    try:
        with Faults(faults_path) as f:
            # Stage 0's THIRD forward of the first step: by then the first
            # microbatch's backward has already accumulated into _g_acc
            # on both stages — exactly the state a replay must not count
            # twice.
            rule = f.add("pipeline.stage.flake-pipe.0.fwd", "error",
                         after=2, times=1, once_global=True,
                         rule_id="flake-s0-fwd")
            got = [plane.train_step(steps[0])]
            assert f.marker_fired(rule)  # the disruption happened
        got += [plane.train_step(mbs) for mbs in steps[1:]]
        assert got == stage_base, (got, stage_base)
        st = plane.stats()
        assert st["gang_epoch"] == 1 and st["epoch"] == 1
        assert st["group"]["restarts"] == 0
        assert st["ledger_refs"] == 0 and st["step"] == 3
    finally:
        report = plane.stop()
    assert report["ledger_refs"] == 0


@pytest.mark.chaos
def test_transient_snapshot_failure_commits_step_on_live_gang(
        pipe_cluster, faults_path):
    """The post-apply snapshot pull fails transiently while the gang stays
    ALIVE (injected error at the stage snapshot site): the snapshot is
    retried on the live gang and the step commits."""
    from ray_tpu_torch.train.pipeline_plane import PipelinePlane

    cfg, params, steps = _setup(seed=13, n_steps=2)
    stage_base = _baseline(cfg, params, steps, n_stages=2)
    plane = PipelinePlane(cfg, params, n_stages=2, n_microbatches=4,
                          lr=1e-2, window=2, name="snap-pipe",
                          device="cpu").start()
    try:
        with Faults(faults_path) as f:
            rule = f.add("pipeline.stage.snap-pipe.1.snap", "error",
                         times=1, once_global=True, rule_id="snap-s1")
            got = [plane.train_step(mbs) for mbs in steps]
            assert f.marker_fired(rule)  # the pull did fail once
        assert got == stage_base, (got, stage_base)
        st = plane.stats()
        assert st["step"] == 2
        assert st["gang_epoch"] == 1 and st["epoch"] == 1
        assert st["group"]["restarts"] == 0
        assert st["ledger_refs"] == 0
        # The retried pull landed: the driver owns a current snapshot, in
        # CPU tensors of its own.
        snap = plane.snapshot_params()
        assert snap is not None and len(snap) == 2
        assert snap[1]["lm_head"].device.type == "cpu"
    finally:
        plane.stop()


# ------------------------------- train-plane trace + step breakdown


@pytest.mark.slow  # the reference's mark
def test_train_trace_rows_bubble_and_step_breakdown(pipe_cluster):
    """A traced 4-stage step renders per-stage process rows whose spans
    carry {step, mb, stage} attrs, and the TRACE-derived bubble fraction
    matches the driver-clock bubble within 10%. Plus the per-step phase
    breakdown: stage-seconds split across fwd/bwd/apply/allgather/idle
    that adds up to stages x wall, surfaced through
    core_summary.pipeline with the MFU estimate gauge."""
    from ray_tpu_torch.scripts import (build_chrome_trace,
                                       train_trace_summary)
    from ray_tpu_torch.train.pipeline_plane import PipelinePlane

    cfg, params, steps = _setup(n_steps=2, n_micro=8, batch=16)
    plane = PipelinePlane(cfg, params, n_stages=4, n_microbatches=8,
                          lr=1e-2, window=4, name="trace-pipe",
                          snapshot_every=0, device="cpu").start()
    old_trace = config.pipe_trace_spans
    old_peak = config.pipe_peak_tflops
    old_sample = config.pipe_trace_sample_every
    try:
        # Warm the stages UNTRACED: the trace window covers exactly one
        # warm step.
        config.pipe_trace_spans = False
        plane.train_step(steps[0])
        config.pipe_trace_spans = True
        config.pipe_trace_sample_every = 1  # trace THIS step (index 1)
        busy0 = plane.stats()["stage_busy_s"]
        t0 = time.monotonic()
        plane.train_step(steps[1])
        wall = time.monotonic() - t0
        busy = [b - a for a, b in
                zip(busy0, plane.stats()["stage_busy_s"])]
        bubble_stats = 1.0 - sum(busy) / (4 * wall)

        bd = plane.stats()["step_breakdown"]
        assert bd["fwd_s"] > 0 and bd["bwd_s"] > 0 and bd["apply_s"] > 0
        assert bd["allgather_s"] == 0.0
        total = (bd["fwd_s"] + bd["bwd_s"] + bd["apply_s"]
                 + bd["allgather_s"] + bd["idle_s"])
        assert abs(total - 4 * bd["wall_s"]) <= 0.02 * 4 * bd["wall_s"]
        assert bd["tokens"] == 256  # 8 mbs x 2 rows x 16 tokens
        assert bd["model_tflops"] > 0

        config.pipe_peak_tflops = 0.001
        snap = {"local": _Registry.get().snapshot()}
        summary = coremetrics.core_summary(snap)["pipeline"]
        for phase in ("fwd", "bwd", "apply", "allgather", "idle"):
            assert phase in summary["step_breakdown_s"]
        assert summary["step_breakdown_s"]["fwd"] > 0
        assert summary["model_tflops"]["trace-pipe"] > 0
        assert summary["mfu_pct"]["trace-pipe"] > 0

        ctl = get_core_worker().controller
        deadline = time.monotonic() + 15.0
        summ = {}
        while time.monotonic() < deadline:
            events = ctl.call("list_task_events", 20000)
            summ = train_trace_summary(events).get("trace-pipe", {})
            if summ.get("cells", 0) >= 64:  # 8 fwd + 8 bwd x 4 stages
                break
            time.sleep(0.25)
        assert summ.get("cells", 0) >= 64, summ
        assert summ["n_stages"] == 4
        trace = build_chrome_trace(events)
        row_names = {t["args"]["name"] for t in trace
                     if t.get("ph") == "M"
                     and t["name"] == "process_name"}
        assert {"stage s0", "stage s1", "stage s2",
                "stage s3"} <= row_names
        fwd = [t for t in trace if t.get("cat") == "span"
               and t["name"] == "fwd"]
        assert fwd and {"step", "mb", "stage"} <= set(fwd[0]["args"])
        bubble_trace = summ["bubble_fraction"]
        assert abs(bubble_trace - bubble_stats) \
            <= 0.10 * max(bubble_stats, bubble_trace), \
            (bubble_trace, bubble_stats)
    finally:
        config.pipe_trace_spans = old_trace
        config.pipe_peak_tflops = old_peak
        config.pipe_trace_sample_every = old_sample
        plane.stop()


# --------------------------------------- crash forensics: post-mortem


@pytest.mark.chaos
@pytest.mark.slow  # the reference's marks
def test_post_mortem_names_killed_stage_from_dumps(pipe_cluster,
                                                   faults_path):
    """SIGKILL a StageActor (faultinject die at its member beat site), let
    the gang reconcile and training resume — then the flight recorder's
    merged dump names the killed member, its stage and the surviving
    gang's epoch, and ``doctor.post_mortem`` over it names them too, from
    the live dump and from the files alone."""
    from ray_tpu_torch import doctor
    from ray_tpu_torch.train.pipeline_plane import PipelinePlane
    from ray_tpu_torch.util import flightrec

    cfg, params, steps = _setup(seed=17, n_steps=3)
    plane = PipelinePlane(cfg, params, n_stages=2, n_microbatches=4,
                          lr=1e-2, window=2, name="pm-pipe",
                          device="cpu").start()
    try:
        pid1 = {i["member"]: i["pid"] for i in
                plane._group.call_all("member_info", timeout=30.0)}["host-1"]
        for i, mbs in enumerate(steps):
            if i == 1:
                _kill_then_step(plane, faults_path,
                                "multihost.member.pm-pipe-gang.host-1.beat",
                                "pm-kill-s1", mbs)
            else:
                plane.train_step(mbs)
        assert plane.stats()["gang_epoch"] == 2  # resumed under epoch 2
        time.sleep(1.5)  # the surviving stages' background flush
        stub = ControllerStub(get_core_worker().controller)
        for dumps in (stub.fr_dump(),
                      flightrec.dump_all(config.flightrec_dir)):
            events = [(src["pid"], e) for src in dumps.values()
                      for e in src["events"]]

            def has(pred):
                return any(pred(pid, e) for pid, e in events)

            assert has(lambda pid, e: pid == pid1
                       and e.get("ev") == "fault.fired"
                       and e.get("action") == "die"
                       and e.get("site") ==
                       "multihost.member.pm-pipe-gang.host-1.beat")
            # The killed member was stage 1 (its setup is on its record).
            assert has(lambda pid, e: pid == pid1
                       and e.get("ev") == "pipe.stage.setup"
                       and e.get("pipeline") == "pm-pipe"
                       and e.get("stage") == 1)
            assert has(lambda pid, e: e.get("ev") == "gang.reconcile"
                       and e.get("group") == "pm-pipe-gang"
                       and e.get("dead") == "host-1")
            assert has(lambda pid, e: e.get("ev") == "pipe.resetup"
                       and e.get("pipeline") == "pm-pipe"
                       and e.get("epoch") == 2)
            assert has(lambda pid, e: e.get("ev") == "gang.form"
                       and e.get("group") == "pm-pipe-gang"
                       and e.get("epoch") == 2)
            deaths = [x for x in doctor.post_mortem(dumps)
                      if x["signature"] == "gang-death"
                      and x["source"] == "group:pm-pipe-gang"]
            assert deaths, dumps
            d = deaths[0]
            assert d["evidence"]["first_dying"] == "host-1"
            assert d["evidence"]["surviving_epoch"] == 2
            assert d["evidence"]["injected"] is True
            assert "host-1" in d["summary"] and "epoch 2" in d["summary"]
            assert "s1" in d["summary"]  # the killed STAGE, by name
    finally:
        plane.stop()


# ----------------------------------------- formation-abort discharge


def test_register_failure_strands_neither_gang_nor_record(pipe_cluster,
                                                          faults_path):
    """``pipe_register`` itself failing during formation (injected error
    at the controller's RPC site) must discharge BOTH acquisitions: the
    already-started gang is shut down (sub-slice released, group record
    dropped) and no pipeline record exists."""
    from ray_tpu_torch.core import multihost
    from ray_tpu_torch.core.placement import cluster_topology
    from ray_tpu_torch.train.pipeline_plane import PipelinePlane

    def reservations():
        out = {}
        for s in cluster_topology()["slices"].values():
            out.update(s["reservations"])
        return out

    assert reservations() == {}  # clean slate from the prior tests
    cfg, params, _steps = _setup(n_steps=1)
    plane = PipelinePlane(cfg, params, n_stages=2, n_microbatches=4,
                          lr=1e-2, name="regfail-pipe", device="cpu")
    with Faults(faults_path) as f:
        f.add("rpc.server.*.pipe_register", "error", times=1,
              rule_id="regfail")
        with pytest.raises(Exception) as ei:
            plane.start()
        assert "faultinject" in str(ei.value)
    assert reservations() == {}
    assert multihost.registry_state("regfail-pipe-gang") is None
    assert plane.registry_state() is None
    plane2 = PipelinePlane(cfg, params, n_stages=2, n_microbatches=4,
                           lr=1e-2, name="regfail-pipe",
                           device="cpu").start()
    try:
        assert plane2.stats()["group"]["state"] == "ALIVE"
    finally:
        plane2.stop()
    assert reservations() == {}


def test_stage_refuses_a_jax_snapshot(pipe_cluster):
    """A snapshot's optimizer state must be the port's own: a stage set up
    from optax state (numpy trees, as the JAX plane snapshots it) raises,
    and the plane's formation discharges the gang."""
    from ray_tpu_torch.core.placement import cluster_topology
    from ray_tpu_torch.train.pipeline_plane import PipelinePlane

    cfg, params, _steps = _setup(n_steps=1)
    plane = PipelinePlane(cfg, params, n_stages=1, n_microbatches=4,
                          lr=1e-2, name="jaxsnap-pipe", device="cpu")
    plane._snapshot = {"step": 1, "stages": [{
        "stage": 0, "step": 1, "params": _weights(),
        "opt_state": ({"count": np.ones((), np.int32)}, ())}]}
    with pytest.raises(Exception, match="not written by ray_tpu_torch"):
        plane.start()
    assert plane.registry_state() is None
    assert not any(s["reservations"]
                   for s in cluster_topology()["slices"].values())
