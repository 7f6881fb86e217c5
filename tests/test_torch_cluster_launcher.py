"""``tests/test_cluster_launcher.py`` on the port's launcher
(``ray_tpu_torch/{cluster_config,command_runner,gpu_vm_api,autoscaler,
cluster_launcher}.py``), under the same names. Its three ``tpu_vm`` cases
run as their ``gpu_vm`` counterparts against an in-memory Compute Engine
(``instances`` and zonal operations): the client's CRUD and hosts, the
provider's host-group gang with its bootstrap and its rollback on a failed
insert, and the dry-run ``up``. No network is used."""

import time
import urllib.parse

import pytest

from ray_tpu_torch.cluster_config import ConfigError, validate_config


# ------------------------------------------------------------------ schema


def test_config_defaults_and_validation():
    cfg = validate_config({"cluster_name": "demo"})
    assert cfg.provider.type == "fake_multinode"
    assert cfg.max_workers == 8

    cfg = validate_config({
        "provider": {"type": "gpu_vm", "project_id": "p",
                     "zone": "us-central1-a",
                     "accelerator_type": "h100-16",
                     "machine_type": "a3-highgpu-8g"},
        "worker": {"resources": {"GPU": 8, "CPU": 8},
                   "labels": {"pool": "gpu"}},
        "min_workers": 1, "max_workers": 4,
        "setup_commands": ["echo hi"],
        "dry_run": True,
    })
    assert cfg.provider.zone == "us-central1-a"
    assert cfg.provider.machine_type == "a3-highgpu-8g"
    assert cfg.worker.resources == {"GPU": 8.0, "CPU": 8.0}


@pytest.mark.parametrize("raw,frag", [
    ({"bogus_key": 1}, "unknown keys"),
    ({"provider": {"type": "aws"}}, "provider.type"),
    ({"provider": {"type": "gpu_vm", "zone": "z"}}, "project_id"),
    ({"min_workers": 5, "max_workers": 2}, "min_workers"),
    ({"worker": {"resources": {"CPU": -1}}}, "non-negative"),
    ({"setup_commands": "echo"}, "list of strings"),
])
def test_config_rejects_bad_input(raw, frag):
    with pytest.raises(ConfigError, match=frag):
        validate_config(raw)


# --------------------------------------------------------- command runners


def test_ssh_runner_builds_argv_dry_run():
    from ray_tpu_torch.command_runner import (HostGroupCommandRunner,
                                              SSHCommandRunner)

    r = SSHCommandRunner("10.0.0.5", user="ray", key_file="/k.pem",
                         dry_run=True)
    r.run("echo hello")
    argv = r.history[0]
    assert argv[0] == "ssh" and "-i" in argv and "/k.pem" in argv
    assert "ray@10.0.0.5" in argv
    r.put("/tmp/a", "/tmp/b")
    assert r.history[1][0] == "scp"

    group = HostGroupCommandRunner(["10.0.0.5", "10.0.0.6"], dry_run=True)
    group.run("start")
    assert len(group.history) == 2  # fanned out to every host of the group
    group.run_per_host("python -m ray_tpu_torch start",
                       [{"RANK": "0"}, {"RANK": "1"}])
    assert any("RANK=1" in " ".join(argv) for argv in group.history)


def test_subprocess_runner_executes():
    from ray_tpu_torch.command_runner import (CommandFailed,
                                              SubprocessCommandRunner)

    r = SubprocessCommandRunner()
    assert r.run("echo ok").strip() == "ok"
    with pytest.raises(CommandFailed):
        r.run("exit 3")


# ----------------------------------------------------------- gpu_vm client


def _fake_cloud(fail_insert=None):
    """In-memory Compute Engine: instances keyed by name, operations done
    at once. An insert of the instance named ``fail_insert`` returns an
    operation that ends in an error, as a zone out of capacity does."""
    state = {"instances": {}, "inserts": 0}

    def transport(verb, url, body, headers):
        path = url.split("/compute/v1/", 1)[1]
        base, _, query = path.partition("?")
        if verb == "POST":
            name = body["name"]
            if name == fail_insert:
                return {"name": f"op-{name}", "status": "DONE",
                        "httpErrorStatusCode": 503,
                        "error": {"errors": [{
                            "message": "ZONE_RESOURCE_POOL_EXHAUSTED"}]}}
            state["inserts"] += 1
            n = state["inserts"]
            state["instances"][name] = {
                "name": name, "status": "RUNNING",
                "labels": dict(body.get("labels") or {}),
                "machineType": body["machineType"],
                "networkInterfaces": [{"networkIP": f"10.0.0.{n}"}]}
            return {"name": f"op-{name}", "status": "DONE"}
        if verb == "DELETE":
            state["instances"].pop(base.rsplit("/", 1)[1], None)
            return {"name": "op-delete", "status": "DONE"}
        if base.endswith("/instances"):
            want = {}
            filt = urllib.parse.parse_qs(query).get("filter", [""])[0]
            for term in filter(None, filt.split(" AND ")):
                key, _, value = term.partition("=")
                want[key.removeprefix("labels.")] = value
            return {"items": [x for x in state["instances"].values()
                              if all(x["labels"].get(k) == v
                                     for k, v in want.items())]}
        return state["instances"].get(base.rsplit("/", 1)[1], {})

    return state, transport


def test_gpu_vm_client_crud_and_hosts():
    from ray_tpu_torch.gpu_vm_api import GpuVmClient

    state, transport = _fake_cloud()
    client = GpuVmClient("proj", "us-central1-a", token_fn=lambda: "tok",
                         transport=transport)
    op = client.create_instance("h1", "a3-highgpu-8g",
                                labels={"ray-cluster": "demo"})
    client.wait_operation(op)
    client.wait_operation(client.create_instance("other", labels={}))
    listed = client.list_instances({"ray-cluster": "demo"})
    assert [x["name"] for x in listed] == ["h1"]
    assert listed[0]["status"] == "RUNNING"
    inst = client.get_instance("h1")
    assert GpuVmClient.instance_host(inst) == "10.0.0.1"
    client.delete_instance("h1")
    assert client.list_instances({"ray-cluster": "demo"}) == []
    # The insert carried the A3 machine type of the zone.
    post = client.requests[0]
    assert post["body"]["machineType"] == (
        "zones/us-central1-a/machineTypes/a3-highgpu-8g")
    assert post["body"]["scheduling"]["onHostMaintenance"] == "TERMINATE"


def test_gpu_vm_provider_host_group_gang_bootstrap():
    """A node of ``h100-16`` is a gang of two 8-card hosts, created as one;
    the bootstrap hook gets every host of the group. An insert that fails
    mid-gang deletes the hosts already created, so no half group is left,
    and the error reaches the caller."""
    from ray_tpu_torch.autoscaler import GPUVMNodeProvider
    from ray_tpu_torch.gpu_vm_api import GpuApiError, GpuVmClient

    state, transport = _fake_cloud()
    client = GpuVmClient("proj", "us-central1-a", token_fn=lambda: "",
                         transport=transport)
    booted = []
    provider = GPUVMNodeProvider(
        client=client, accelerator_type="h100-16",
        bootstrap=lambda node, labels: booted.append(
            (node["hosts"], labels)))
    pid = provider.create_node({"GPU": 8.0}, {"pool": "gpu"})
    assert provider.non_terminated_nodes() == [pid]
    assert len(state["instances"]) == 2
    hosts, labels = booted[0]
    assert hosts == ["10.0.0.1", "10.0.0.2"]
    assert labels["provider_node_id"] == pid
    provider.terminate_node(pid)
    assert provider.non_terminated_nodes() == []
    assert state["instances"] == {}

    state, transport = _fake_cloud(fail_insert="ray-gpu-group-1-1")
    provider = GPUVMNodeProvider(transport, "proj", "us-central1-a",
                                 accelerator_type="h100-16")
    with pytest.raises(GpuApiError, match="EXHAUSTED"):
        provider.create_node({"GPU": 8.0}, {})
    assert state["instances"] == {}  # host 0 rolled back
    assert provider.non_terminated_nodes() == []


# -------------------------------------------------------------- end-to-end


@pytest.mark.slow  # end-to-end launcher soak, slow as in the reference;
# the autoscaler decision units stay tier-1
@pytest.mark.timeout_s(170)
def test_up_fake_multinode_autoscales_end_to_end(tmp_path):
    """``up`` on a fake_multinode YAML boots a real autoscaling cluster:
    demand appears -> workers launch -> tasks run on them -> idle timeout
    scales back down."""
    import yaml

    import ray_tpu_torch
    from ray_tpu_torch.cluster_launcher import up

    config = tmp_path / "cluster.yaml"
    config.write_text(yaml.safe_dump({
        "cluster_name": "fake-e2e",
        "provider": {"type": "fake_multinode"},
        "min_workers": 0,
        "max_workers": 3,
        "idle_timeout_minutes": 0.05,  # 3s
        "head": {"resources": {"CPU": 0.1}},
        "worker": {"resources": {"CPU": 2}, "labels": {"pool": "w"}},
    }))
    cluster = up(str(config))
    try:
        ray_tpu_torch.init(address=cluster.address)

        @ray_tpu_torch.remote
        def where():
            from ray_tpu_torch.core.runtime import get_core_worker

            return get_core_worker().node_id.hex()

        # Head has 0.1 CPU: these need autoscaled workers.
        refs = [where.options(num_cpus=1).remote() for _ in range(6)]
        nodes = ray_tpu_torch.get(refs, timeout=120)
        assert cluster.autoscaler.num_launches >= 1
        head_hex = cluster.head_node.node_id.hex()
        assert all(n != head_hex for n in nodes)

        # Scale-down: workers idle past the (3s) timeout get terminated.
        deadline = time.monotonic() + 60
        while cluster.provider.non_terminated_nodes():
            assert time.monotonic() < deadline, "idle workers never reaped"
            time.sleep(0.5)
        assert cluster.autoscaler.num_terminations >= 1
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()


def _gpu_yaml(tmp_path, name, **extra):
    import yaml

    config = tmp_path / f"{name}.yaml"
    config.write_text(yaml.safe_dump({
        "cluster_name": name,
        "provider": {"type": "gpu_vm", "project_id": "proj",
                     "zone": "us-central1-a",
                     "accelerator_type": "h100-32"},
        "dry_run": True, **extra}))
    return str(config)


def test_up_gpu_vm_dry_run_records_provisioning(tmp_path):
    """Dry-run gpu_vm ``up``/``down``: the exact REST requests and SSH argv
    are recorded without egress — head instance insert, per-host setup +
    start, teardown delete."""
    from ray_tpu_torch.cluster_launcher import down, up

    config = _gpu_yaml(
        tmp_path, "gpu32", max_workers=2,
        worker={"resources": {"GPU": 8, "CPU": 64}},
        auth={"ssh_user": "ray", "ssh_private_key": "/k.pem"},
        setup_commands=["pip install -e ."])
    cluster = up(config)
    try:
        reqs = cluster.provider._client.requests
        post = next(r for r in reqs if r["verb"] == "POST")
        assert post["body"]["name"] == "gpu32-head"
        assert post["body"]["machineType"].endswith("/a3-highgpu-8g")
        assert any("started head" in a for a in cluster.actions)
        assert cluster.provider.hosts_per_node() == 4  # h100-32
    finally:
        cluster.shutdown()
    assert down(config)  # records the delete intent


def test_cli_up_down_dry_run(tmp_path, capsys):
    from ray_tpu_torch.scripts import main

    config = _gpu_yaml(tmp_path, "cli")
    assert main(["up", config]) == 0
    assert "dry run" in capsys.readouterr().out
    assert main(["down", config]) == 0
    assert "cluster down" in capsys.readouterr().out
