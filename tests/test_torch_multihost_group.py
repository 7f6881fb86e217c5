"""The port's ``HostGroup`` (``ray_tpu_torch.core.multihost``) on the CPU:
a counterpart of all nine of ``tests/test_multihost_group.py``'s cases
(same names and settings; the chaos marks kept), on one module-scoped
``init(num_cpus=8)`` whose node advertises a virtual multi-host slice
(``RAY_TPU_VIRTUAL_SLICE=4x4/4``: a 4x4 grid, 4 chips per host = 4
virtual hosts). ``test_doctor_names_gang_hang_straggler`` and the
coordinator failover's post-mortem half assert the port's doctor's
verdicts (``ray_tpu_torch.doctor``, ROADMAP.md queue 1, item 4, the CLI,
dashboard and doctor), the failover beside the flight recorder's merged
dump that the doctor reads.

Plus what the port adds: ``form_mesh`` forms one gloo process group
across the members of a virtual slice (an ``all_reduce`` crosses the
process boundary), and a 1-host group's decode is equal to the port's
engine in this process token for token, and to the JAX engine under the
greedy margin rule (top-2 margin 1e-4).
"""

import os
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.core import multihost
from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.multihost import (GangPlacementError, HostGroup,
                                          member_name)
from ray_tpu_torch.core.placement import cluster_topology
from ray_tpu_torch.core.rpc_stubs import ControllerStub
from ray_tpu_torch.core.runtime import get_core_worker
from ray_tpu_torch.util import faultinject
from ray_tpu_torch.util.faultinject import Faults

MARGIN_TOL = 1e-4


@pytest.fixture(scope="module")
def faults_path(tmp_path_factory):
    return str(tmp_path_factory.mktemp("faults") / "mh_faults.json")


@pytest.fixture(scope="module")
def mh_cluster(tmp_path_factory, faults_path):
    """One cluster for the whole module: a virtual 4-host slice with fault
    injection AND the flight recorder plumbed into every process (env set
    BEFORE init so workers inherit both; a per-run recorder dir keeps
    other runs' files out of the post-mortem)."""
    fr_dir = str(tmp_path_factory.mktemp("flightrec"))
    saved = {k: os.environ.get(k)
             for k in ("RAY_TPU_VIRTUAL_SLICE", "RAY_TPU_FAULTINJECT_PATH",
                       "RAY_TPU_FLIGHTREC_DIR")}
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


def _reservations():
    slices = cluster_topology()["slices"]
    out = {}
    for s in slices.values():
        out.update(s["reservations"])
    return out


def _wait_for(pred, timeout=45.0, period=0.1):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(period)
    return False


# ------------------------------------------------ gang spawn/teardown


def test_gang_spawn_alignment_and_teardown(mh_cluster):
    """Formation hands every member the SAME group geometry and a
    disjoint chip mask covering the sub-slice; teardown releases the
    reservation exactly once and drops the group record."""
    g = HostGroup(2, name="form-gang").start()
    try:
        assert g.state == "ALIVE" and g.epoch == 1
        infos = g.call_all("member_info", timeout=30.0)
        coords = {i["coordinator_address"] for i in infos}
        assert len(coords) == 1 and None not in coords
        assert [i["process_id"] for i in infos] == [0, 1]
        assert {i["num_processes"] for i in infos} == {2}
        assert {i["epoch"] for i in infos} == {1}
        assert [i["member"] for i in infos] == ["host-0", "host-1"]
        # A virtual slice's members join their group over gloo.
        assert {i["device_type"] for i in infos} == {"cpu"}
        masks = [tuple(map(tuple, i["local_device_ids"])) for i in infos]
        assert all(len(m) == 4 for m in masks)
        assert not (set(masks[0]) & set(masks[1]))
        coord = g.coordinator()
        assert coord["member"] == "host-0"
        assert coord["address"] in coords
        st = multihost.registry_state(g.group_id)
        assert st["num_hosts"] == 2 and st["epoch"] == 1
        assert "coordinator" in st["kv_keys"]
        sub = g.status()["sub_slice"]
        assert sub["reservation_id"] in _reservations()
    finally:
        g.shutdown()
    assert g.status()["releases"] == 1
    assert g.status()["sub_slice"] is None
    assert _reservations() == {}
    assert multihost.registry_state(g.group_id) is None
    # Idempotent: a second shutdown releases nothing further.
    g.shutdown()
    assert g.status()["releases"] == 1


def test_all_or_nothing_refusal_feeds_pending_demand(mh_cluster):
    """A gang no single slice can host is REFUSED before any member
    spawns, and the refusal surfaces as autoscaler pending demand."""
    g = HostGroup(64, name="huge-gang")
    with pytest.raises(GangPlacementError):
        g.start()
    assert g.members == []
    assert _reservations() == {}
    assert multihost.registry_state("huge-gang") is None
    state = ControllerStub(
        get_core_worker().controller).autoscaler_state()
    chips = [d["resources"].get("chips", 0)
             for d in state["pending_demand"]]
    assert 64 * 4 in chips, state["pending_demand"]


# -------------------------------------------- program-hash refusal


def test_program_hash_mismatch_is_typed_refusal(mh_cluster):
    """Mismatched program fingerprints at the pre-collective barrier
    raise ProgramHashMismatch on EVERY member — a typed refusal where
    the collective would have hung."""
    g = HostGroup(2, name="hash-gang").start()
    try:
        t0 = time.monotonic()
        refs = [g.members[0].program_barrier.remote("step", "hashA", 20.0),
                g.members[1].program_barrier.remote("step", "hashB", 20.0)]
        for ref in refs:
            with pytest.raises(Exception) as ei:
                rt.get(ref, timeout=30.0)
            assert "ProgramHashMismatch" in str(ei.value)
            assert "hashA" in str(ei.value) and "hashB" in str(ei.value)
        assert time.monotonic() - t0 < 15.0
        out = g.call_all("program_barrier", "step2", "same", 20.0,
                         timeout=30.0)
        assert all(set(p.values()) == {"same"} for p in out)
    finally:
        g.shutdown()


# ------------------------------------- death + coordinator failover


@pytest.mark.chaos
def test_member_death_reconciles_whole_gang(mh_cluster, faults_path):
    """SIGKILL one member (faultinject die at its beat site) -> the
    WHOLE gang is killed and re-formed under a bumped epoch; the old
    sub-slice is released exactly once; no old member survives."""
    g = HostGroup(2, name="death-gang", max_group_restarts=1).start()
    try:
        pids = {i["member"]: i["pid"]
                for i in g.call_all("member_info", timeout=30.0)}
        rid_before = g.status()["sub_slice"]["reservation_id"]
        with Faults(faults_path) as f:
            f.add("multihost.member.death-gang.host-1.beat", "die",
                  once_global=True, rule_id="kill-h1")
            assert _wait_for(lambda: g.status()["epoch"] == 2
                             and g.status()["state"] == "ALIVE")
        st = g.status()
        assert st["restarts"] == 1
        assert st["releases"] == 1
        assert "host-1" in st["death_cause"]
        pids2 = {i["member"]: i["pid"]
                 for i in g.call_all("member_info", timeout=30.0)}
        assert not (set(pids.values()) & set(pids2.values()))
        assert {i["epoch"] for i in
                g.call_all("member_info", timeout=30.0)} == {2}
        res = _reservations()
        assert rid_before not in res and len(res) == 1
    finally:
        g.shutdown()
    assert _reservations() == {}


@pytest.mark.chaos
def test_coordinator_failover_and_stale_epoch_fence(mh_cluster,
                                                    faults_path):
    """Kill the COORDINATOR: re-election completes under a bumped epoch
    (fresh fenced election record), and the deposed coordinator's
    stale-epoch writes/barrier entries are rejected. The flight
    recorder's merged dump names the death: the killed coordinator's own
    file carries the injected die, and the driver's the reconcile and the
    re-formation at epoch 2."""
    from ray_tpu_torch.util import flightrec

    g = HostGroup(2, name="coord-gang", max_group_restarts=1).start()
    try:
        assert g.coordinator()["epoch"] == 1
        dead_pid = g.call_all("member_info", timeout=30.0)[0]["pid"]
        with Faults(faults_path) as f:
            f.add("multihost.member.coord-gang.host-0.beat", "die",
                  once_global=True, rule_id="kill-h0")
            assert _wait_for(lambda: g.status()["epoch"] == 2
                             and g.status()["state"] == "ALIVE")
        st = g.status()
        assert "coordinator" in st["death_cause"]
        coord = g.coordinator()
        assert coord["epoch"] == 2 and coord["member"] == "host-0"
        stub = ControllerStub(get_core_worker().controller)
        put = stub.mh_group_put("coord-gang", "coordinator",
                                {"member": "host-0",
                                 "address": "zombie:1", "epoch": 1}, 1)
        assert put == {"ok": False, "reason": "stale_epoch", "epoch": 2}
        assert g.coordinator()["address"] != "zombie:1"
        bar = stub.mh_barrier("coord-gang", "zombie-step", "host-0", 1,
                              "h", 5.0)
        assert bar == {"ok": False, "reason": "stale_epoch", "epoch": 2}
        dump = flightrec.cluster_dump()
        events = [(src["pid"], e) for src in dump.values()
                  for e in src["events"]]

        def has(pred):
            return any(pred(pid, e) for pid, e in events)

        assert has(lambda pid, e: pid == dead_pid
                   and e.get("ev") == "fault.fired"
                   and e.get("action") == "die"
                   and e.get("site") ==
                   "multihost.member.coord-gang.host-0.beat")
        assert has(lambda pid, e: e.get("ev") == "gang.reconcile"
                   and e.get("group") == "coord-gang"
                   and e.get("dead") == "host-0"
                   and e.get("coordinator_died") is True)
        assert has(lambda pid, e: e.get("ev") == "gang.form"
                   and e.get("group") == "coord-gang"
                   and e.get("epoch") == 2)
        # The same death explained post-mortem, from the dumps alone:
        # the killed coordinator is the first-dying member, and the
        # surviving gang's epoch is on record.
        from ray_tpu_torch import doctor

        deaths = [x for x in doctor.post_mortem(dump)
                  if x["signature"] == "gang-death"
                  and x["source"] == "group:coord-gang"]
        assert deaths
        d = deaths[0]
        assert d["evidence"]["first_dying"] == "host-0"
        assert d["evidence"]["surviving_epoch"] == 2
        assert d["evidence"]["injected"] is True
        assert "host-0" in d["summary"] and "epoch 2" in d["summary"]
        assert "SIGKILL" in d["summary"]
    finally:
        g.shutdown()


def test_zombie_member_self_fences(mh_cluster):
    """A member of a deposed epoch learns it is fenced from its beat
    and refuses all further group operations."""
    g = HostGroup(1, name="fence-gang").start()
    try:
        member = g.members[0]
        assert rt.get(member.beat_once.remote(),
                      timeout=10.0)["fenced"] is False
        _gid, epoch = multihost.register_gang(1, group_id="fence-gang")
        assert epoch == 2
        assert rt.get(member.beat_once.remote(),
                      timeout=10.0)["fenced"] is True
        info = rt.get(member.member_info.remote(), timeout=10.0)
        assert info["fenced"] is True
        with pytest.raises(Exception) as ei:
            rt.get(member.program_barrier.remote("b", "h", 5.0),
                   timeout=10.0)
        assert "GroupEpochFenced" in str(ei.value)
    finally:
        g.shutdown()


# ------------------------------------------ single-process parity


def _tiny_pair():
    from torch_parity import tiny_pair

    return tiny_pair("f32", seed=0)


def _engine_decode(tcfg, params, prompt, n):
    from ray_tpu_torch.serve.decode import DecodeEngine

    eng = DecodeEngine(params, tcfg, slots=2, capacity=64, device="cpu")
    req = eng.submit(list(prompt), max_new_tokens=n)
    for _ in range(200):
        if req.done.is_set():
            break
        eng.step()
    assert req.done.is_set()
    return list(req.output)


def test_single_host_group_decode_parity(mh_cluster):
    """A 1-host HostGroup running the port's decode engine produces
    tokens equal to the port's engine in this process (the same carried
    weights), and those agree with the JAX engine under the margin
    rule."""
    import jax

    from ray_tpu.serve.decode import DecodeEngine as JEngine
    from torch_parity import assert_greedy_agrees, greedy_with_margins

    def decode_on_member(member, np_params, cfg_kw, prompt, n):
        import torch

        from ray_tpu_torch.models import llama
        from ray_tpu_torch.serve.decode import DecodeEngine

        assert member.num_processes == 1 and member.process_id == 0
        # The pre-collective check still runs (a 1-host barrier
        # completes immediately): parity holds THROUGH the gang path.
        member.barrier("parity", "engine-v1", 20.0)
        cfg = llama.LlamaConfig(dtype=torch.float32, **cfg_kw)
        params = llama.params_from_numpy(np_params, cfg, device="cpu")
        eng = DecodeEngine(params, cfg, slots=2, capacity=64,
                           device="cpu")
        req = eng.submit(list(prompt), max_new_tokens=n)
        for _ in range(200):
            if req.done.is_set():
                break
            eng.step()
        assert req.done.is_set()
        return list(req.output)

    from torch_parity import TINY

    jcfg, jp, tcfg, tp = _tiny_pair()
    prompt, n = [3, 1, 4, 1, 5], 12
    np_params = jax.tree.map(np.asarray, jp)
    g = HostGroup(1, name="parity-gang").start()
    try:
        [via_group] = g.broadcast(decode_on_member, np_params, TINY,
                                  prompt, n, timeout=120.0)
    finally:
        g.shutdown()
    assert via_group == _engine_decode(tcfg, tp, prompt, n)
    assert len(via_group) == n
    jeng = JEngine(jp, jcfg, slots=2, capacity=64)
    jreq = jeng.submit(prompt, max_new_tokens=n)
    for _ in range(200):
        if jreq.done.is_set():
            break
        jeng.step()
    _solo, margins = greedy_with_margins(tcfg, tp, prompt, n)
    assert_greedy_agrees(via_group, list(jreq.output), margins, MARGIN_TOL)


def test_form_mesh_joins_one_gloo_group(mh_cluster):
    """``form_mesh`` joins every member of a virtual slice into one gloo
    process group (each member's own context through the bootstrap
    barrier): an ``all_reduce`` crosses the process boundary, and a
    re-formed gang joins a fresh group at the new coordinator."""
    def reduce_ranks(member):
        import torch
        import torch.distributed as dist

        t = torch.tensor([float(member.process_id + 1)])
        dist.all_reduce(t)
        return (dist.get_rank(), dist.get_world_size(), float(t))

    g = HostGroup(3, name="mesh-gang", max_group_restarts=1).start()
    try:
        assert g.form_mesh(timeout=120.0) == [3, 3, 3]
        assert g.broadcast(reduce_ranks, timeout=60.0) == [
            (r, 3, 6.0) for r in range(3)]
        addr = g.coordinator()["address"]
        rt.kill(g.members[2])
        assert _wait_for(lambda: g.status()["epoch"] == 2
                         and g.status()["state"] == "ALIVE")
        assert g.coordinator()["address"] != addr
        assert g.form_mesh(timeout=120.0) == [3, 3, 3]
        assert g.broadcast(reduce_ranks, timeout=60.0)[0] == (0, 3, 6.0)
        assert g.call_all("shutdown_torch", 10.0, timeout=30.0) == [
            True] * 3
    finally:
        g.shutdown()
    assert _reservations() == {}


# ------------------------------------------- doctor: gang-hang


def _agg(source="n1/node/pid1"):
    from ray_tpu_torch.util.metrics import _Registry

    return {source: _Registry.get().snapshot()}


@pytest.mark.chaos
def test_doctor_names_gang_hang_straggler(mh_cluster, faults_path):
    """One member's barrier entry is delayed (faultinject at
    multihost.barrier) -> its barrier-entered gauge stays 0 while the
    rest of the gang parks at 1 across the whole window, and the
    doctor names the straggler host."""
    from ray_tpu_torch import doctor

    g = HostGroup(2, name="hang-gang").start()
    refs = []
    try:
        with Faults(faults_path) as f:
            f.add("multihost.barrier.hang-gang.host-1", "delay",
                  delay_s=4.0)
            refs = [m.program_barrier.remote("stuck-step", "h", 25.0)
                    for m in g.members]
            # host-0 is parked in the barrier; host-1 is sleeping at
            # the injection point and never arrived.
            assert _wait_for(lambda: (multihost.registry_state(
                "hang-gang")["barriers"].get("stuck-step", {})
                .get("arrived") == ["host-0"]), timeout=10.0)
            before = _agg()
            time.sleep(1.2)
            after = _agg()
        findings = doctor.diagnose(before, after, 1.2)
        hangs = [x for x in findings if x["signature"] == "gang-hang"
                 and "hang-gang" in x["source"]]
        assert hangs, findings
        assert hangs[0]["severity"] == "critical"
        assert "host-1" in hangs[0]["summary"]  # the straggler, named
        assert "host-0" in hangs[0]["summary"]  # who is parked
        # The delay elapses, the straggler arrives, the barrier
        # completes: the "hang" resolves without any intervention...
        assert all(set(p.values()) == {"h"}
                   for p in rt.get(refs, timeout=60.0))
        # ...and the signature clears (entered gauges uniform again).
        snap = _agg()
        assert [x for x in doctor.diagnose(snap, snap, 1.0)
                if x["signature"] == "gang-hang"] == []
    finally:
        g.shutdown()


# ------------------------------- formation fence verdict (no cluster)


def test_form_aborts_when_reservation_write_is_fenced(monkeypatch):
    """The reservation write during formation is a FENCED group-KV write,
    and its verdict must be honored: a stale-epoch rejection aborts
    formation, releases the sub-slice exactly once, drops the
    half-registered group record, and spawns nothing."""
    from ray_tpu_torch.core import rpc_stubs
    from ray_tpu_torch.core.multihost import GroupEpochFenced

    calls = []

    class FencingStub:
        def __init__(self, client):
            pass

        def topology_state(self, timeout=None):
            return {"slices": {"s0": {"chips_per_host": 4}}}

        def reserve_subslice(self, owner, chips, timeout=None):
            calls.append(("reserve", chips))
            return {"reservation_id": "res-1", "slice_id": "s0",
                    "nodes": ["n0", "n1"], "origin": [0, 0],
                    "shape": [4, 8]}

        def mh_register_group(self, group_id, num_hosts, res, owner,
                              timeout=None):
            calls.append(("register", group_id))
            return {"epoch": 3}

        def mh_group_put(self, group_id, key, value, epoch,
                         timeout=None):
            calls.append(("put", key, epoch))
            return {"ok": False, "reason": "stale_epoch", "epoch": 4}

        def release_subslice(self, reservation_id, timeout=None):
            calls.append(("release", reservation_id))
            return True

        def mh_drop_group(self, group_id, timeout=None):
            calls.append(("drop", group_id))
            return True

    monkeypatch.setattr(multihost, "_controller_client", lambda: None)
    monkeypatch.setattr(rpc_stubs, "ControllerStub", FencingStub)
    g = HostGroup(2, chips_per_host=4, name="fenced-form")
    with pytest.raises(GroupEpochFenced) as exc:
        g._form()
    assert "rejected" in str(exc.value)
    assert ("put", "reservation", 3) in calls
    assert ("release", "res-1") in calls
    assert ("drop", "fenced-form") in calls
    assert g._members == [] and g._sub is None and g._epoch == 0
    assert member_name(1) == "host-1"
