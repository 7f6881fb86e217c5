"""The launcher and autopilot family held against the JAX package on shared
inputs: the same cluster YAML gives equal configs and equal validation
errors, the same demand gives equal bin-packing, launch and idle-teardown
decisions, and the same doctor findings give an equal autopilot plan.
Fields and messages that name the cloud provider (``gpu_vm`` with its
``machine_type`` against ``tpu_vm`` with its ``runtime_version``) are the
one deliberate difference and are left out of the comparison."""

import dataclasses

import pytest

PKGS = ("ray_tpu", "ray_tpu_torch")


def _mod(pkg: str, name: str):
    import importlib

    return importlib.import_module(f"{pkg}.{name}")


# ------------------------------------------------------------- configs

YAMLS = [
    {"cluster_name": "demo"},
    {"cluster_name": "fake", "provider": {"type": "fake_multinode"},
     "min_workers": 1, "max_workers": 3, "idle_timeout_minutes": 0.5,
     "head": {"resources": {"CPU": 2}, "labels": {"role": "head"}},
     "worker": {"resources": {"CPU": 4, "GPU": 1},
                "labels": {"pool": "gpu"}},
     "auth": {"ssh_user": "me", "ssh_private_key": "~/.ssh/k"},
     "setup_commands": ["echo a", "echo b"], "dry_run": True},
    {"worker": {"resources": {"CPU": 0}}, "max_workers": 0},
]

BAD = [
    {"bogus_key": 1},
    {"cluster_name": ""},
    {"provider": []},
    {"min_workers": -1},
    {"min_workers": 5, "max_workers": 2},
    {"idle_timeout_minutes": -3},
    {"head": {"resources": {"CPU": -1}}},
    {"worker": {"resources": {"CPU": "many"}}},
    {"worker": {"flavor": "big"}},
    {"auth": {"password": "x"}},
    {"setup_commands": "echo"},
    {"dry_run": "yes"},
]


def _shared(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    for key in ("accelerator_type", "runtime_version", "machine_type"):
        out["provider"].pop(key, None)
    return out


@pytest.mark.parametrize("raw", YAMLS, ids=range(len(YAMLS)))
def test_same_yaml_gives_equal_configs(raw, tmp_path):
    import yaml

    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(raw))
    jax_cfg, port_cfg = (_mod(p, "cluster_config").load_config(str(path))
                         for p in PKGS)
    assert _shared(port_cfg) == _shared(jax_cfg)


@pytest.mark.parametrize("raw", BAD, ids=range(len(BAD)))
def test_same_bad_yaml_gives_equal_errors(raw):
    errors = []
    for pkg in PKGS:
        mod = _mod(pkg, "cluster_config")
        with pytest.raises(mod.ConfigError) as info:
            mod.validate_config(raw)
        errors.append(str(info.value))
    assert errors[1] == errors[0]


# ------------------------------------------------------------ autoscaler


class _State:
    """A controller's ``autoscaler_state`` for the planner, scripted."""

    def __init__(self, nodes, demand):
        self.state = {"nodes": nodes, "pending_demand": demand,
                      "tainted": []}

    def autoscaler_state(self):
        return self.state


class _Provider:
    def __init__(self, pids=()):
        self.created = []
        self.terminated = []
        self._pids = list(pids)

    def create_node(self, resources, labels):
        self.created.append((dict(resources), dict(labels)))
        self._pids.append(f"new-{len(self.created)}")
        return self._pids[-1]

    def terminate_node(self, pid):
        self.terminated.append(pid)
        self._pids.remove(pid)

    def non_terminated_nodes(self):
        return list(self._pids)


def _node(nid, total, avail, pid, queue=0, labels=None):
    return {"node_id": nid, "alive": True, "resources": dict(total),
            "available": dict(avail), "queue_len": queue,
            "labels": {"provider_node_id": pid, **(labels or {})}}


SCENES = {
    # Demand the busy cluster cannot hold: bin-packed onto new nodes of
    # 4 CPUs, capped by max_nodes.
    "pack": ([_node("a", {"CPU": 4}, {"CPU": 0}, "p-a")],
             [{"CPU": 1}, {"CPU": 2}, {"CPU": 2}, {"CPU": 3},
              {"CPU": 4}, {"CPU": 1}], {"max_nodes": 3}),
    # Labelled demand only counts against a template that satisfies it.
    "labels": ([_node("a", {"CPU": 8}, {"CPU": 8}, "p-a")],
               [{"resources": {"CPU": 1}, "labels": {"pool": "w"}},
                {"resources": {"CPU": 1}, "labels": {"pool": "other"}},
                {"resources": {"CPU": 1}}], {"max_nodes": 4}),
    # Demand no node type can hold launches nothing; an idle node past
    # the timeout is torn down, a busy one is kept.
    "idle": ([_node("a", {"CPU": 4}, {"CPU": 4}, "p-a"),
              _node("b", {"CPU": 4}, {"CPU": 1}, "p-b")],
             [{"CPU": 64}], {"max_nodes": 4, "min_nodes": 0}),
    # The floor launches nodes with no demand at all.
    "floor": ([], [], {"max_nodes": 4, "min_nodes": 2}),
}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_same_demand_gives_equal_decisions(scene):
    nodes, demand, kw = SCENES[scene]
    out = []
    for pkg in PKGS:
        mod = _mod(pkg, "autoscaler")
        provider = _Provider(n["labels"]["provider_node_id"]
                             for n in nodes)
        scaler = mod.StandardAutoscaler(
            _State(nodes, demand), provider, {"CPU": 4.0},
            idle_timeout_s=0.0, node_labels={"pool": "w"}, **kw)
        scaler.update()   # the first pass starts the idle clocks
        scaler.update()
        out.append((provider.created, provider.terminated,
                    scaler.num_launches, scaler.num_terminations))
    assert out[1] == out[0]
    assert out[0][2] > 0 or out[0][3] > 0  # every scene decides something


# ------------------------------------------------------------- autopilot


def _findings():
    return [
        {"signature": "slo-burn", "severity": "warning",
         "source": "deployment:llama", "evidence": {"p99_s": 9.0},
         "remediation": {"action": "resize-deployment", "target": "llama",
                         "evidence_keys": ["p99_s"]}},
        {"signature": "heartbeat-rtt-outlier", "severity": "warning",
         "source": "node:aabbccdd", "evidence": {"node_p99_s": 1.0},
         "remediation": {"action": "taint-host", "target": "aabbccdd",
                         "evidence_keys": ["node_p99_s"]}},
        {"signature": "rpc-backpressure", "severity": "warning",
         "source": "deployment:llama", "evidence": {"queued": 40},
         "remediation": {"action": "shed-tenant", "target": "llama",
                         "evidence_keys": ["queued"]}},
        {"signature": "gang-death", "severity": "critical",
         "source": "group:g1",
         "evidence": {"first_dying": "host-1", "old_epoch": 3},
         "remediation": {"action": "reschedule-gang", "target": "g1",
                         "evidence_keys": ["first_dying"]}},
        {"signature": "no-remedy", "severity": "info", "source": "x",
         "evidence": {}},
    ]


class _Client:
    def __init__(self):
        self.calls = []

    def call(self, method, *args, **kwargs):
        kwargs.pop("timeout", None)
        self.calls.append(method)
        if method == "list_nodes":
            return [{"node_id": "aabbccdd" + "0" * 24, "alive": True}]
        if method == "mh_group_state":
            return {"epoch": 3, "members": {"host-1": {}}}
        if method == "mh_group_put":
            return {"ok": True, "epoch": 3}
        if method == "taint_host":
            return {"node": args[0], "ttl_s": 120.0}
        if method in ("kv_put",):
            return True
        if method == "taint_state":
            return {}
        raise KeyError(method)


class _Serve:
    def status(self):
        return {"llama": {"load": 20.0, "replicas": 1, "queue_max": 64}}

    def autopilot_resize(self, deployment, delta, epoch):
        return {"ok": True, "target": 2, "epoch": epoch}

    def autopilot_shed(self, deployment, queue_max, epoch):
        return {"ok": True, "queue_max": queue_max, "replicas": 1,
                "epoch": epoch}


@pytest.mark.parametrize("dry_run", [True, False], ids=["dry", "live"])
def test_same_findings_give_an_equal_autopilot_plan(monkeypatch, dry_run):
    plans = []
    for pkg in PKGS:
        config = _mod(pkg, "core.config").config
        monkeypatch.setattr(config, "autopilot_enabled", True)
        monkeypatch.setattr(config, "autopilot_dry_run", dry_run)
        monkeypatch.setattr(config, "autopilot_hysteresis_windows", 2)
        monkeypatch.setattr(config, "autopilot_burst", 2)
        client = _Client()
        pilot = _mod(pkg, "autopilot").Autopilot(
            client=client, serve=_Serve(), clock=lambda: 1000.0)
        windows = [pilot.step(_findings(), serve_epoch=7)
                   for _ in range(3)]
        plans.append((windows, sorted(set(client.calls)),
                      pilot.status()["streaks"]))
    assert plans[1] == plans[0]
    first, second, _third = plans[0][0]
    assert first == []  # one window is below the hysteresis damper
    assert {r["action"] for r in second} == {
        "resize-deployment", "taint-host", "shed-tenant",
        "reschedule-gang"}
    if dry_run:
        assert {r["outcome"] for r in second} == {"dry-run"}
