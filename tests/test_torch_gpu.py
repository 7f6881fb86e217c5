"""``ray_tpu_torch.gpu`` against ``ray_tpu.tpu``: the same function names
and rules, with ``"TPU"`` mapped to ``"GPU"`` in the bundles. The peak
lookup follows the JAX rule (the longest table key the kind contains
wins, an unknown kind gets the default); ``detect_chip_count`` is
``core.api.detect_gpus``, counted here without a card (no ``nvidia-smi``
on this machine, then a fake one); ``device_kind`` creates no CUDA
context. Values are exact: no tolerance."""

import subprocess

import pytest

from ray_tpu import tpu
from ray_tpu_torch import gpu
from ray_tpu_torch.core import api


KINDS = ["NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe", "NVIDIA H100 NVL",
         "NVIDIA A100-SXM4-80GB", "NVIDIA A100 80GB PCIe", "Tesla T4",
         "TPU v5 lite", "TPU v4", "TPU v5p", "TPU v6e", ""]


def test_function_names_match_tpu():
    for name in ("detect_chip_count", "device_kind", "peak_flops_per_chip",
                 "pod_slice_hosts", "slice_placement_group"):
        assert callable(getattr(tpu, name)) and callable(getattr(gpu, name))


@pytest.mark.parametrize("kind, want", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA H100 NVL", 835e12), ("NVIDIA A100-SXM4-80GB", 312e12),
    ("NVIDIA A100 80GB PCIe", 312e12), ("Tesla T4", 989e12)])
def test_peak_flops_table(kind, want):
    assert gpu.peak_flops_per_chip(kind) == want


def test_peak_lookup_rule_matches_tpu(monkeypatch):
    """Given the JAX table and default, the port's lookup picks what the
    JAX one picks for every kind."""
    monkeypatch.setattr(gpu, "_PEAK_BF16_FLOPS", dict(tpu._PEAK_BF16_FLOPS))
    monkeypatch.setattr(gpu, "_DEFAULT_KIND", "v5e")
    for kind in KINDS:
        if kind:
            assert gpu.peak_flops_per_chip(kind) == \
                tpu.peak_flops_per_chip(kind), kind


@pytest.mark.parametrize("cards, hosts", [(8, 1), (16, 2), (32, 4), (4, 1)])
def test_pod_slice_hosts(cards, hosts):
    assert gpu.pod_slice_hosts(f"h100-{cards}") == hosts


@pytest.mark.parametrize("pod", ["v5e-16", "v4-8", "v5p-32", "v5e-4"])
def test_slice_bundles_match_tpu(monkeypatch, pod):
    """At the JAX module's 4 chips a host, the port's bundles are the JAX
    ones with ``TPU`` renamed ``GPU``; the strategy is STRICT_SPREAD."""
    import ray_tpu.core.placement as jplace
    import ray_tpu_torch.core.placement as tplace

    seen = {}

    def fake(name):
        def placement_group(bundles, strategy="PACK", **kw):
            seen[name] = (bundles, strategy)
            return name
        return placement_group

    monkeypatch.setattr(jplace, "placement_group", fake("jax"))
    monkeypatch.setattr(tplace, "placement_group", fake("port"))
    monkeypatch.setattr(gpu, "_CHIPS_PER_HOST_DEFAULT", 4)
    tpu.slice_placement_group(pod, chips_per_host=4, extra_cpu=2.0)
    gpu.slice_placement_group(pod, chips_per_host=4, extra_cpu=2.0)
    jb, js = seen["jax"]
    pb, ps = seen["port"]
    assert ps == js == "STRICT_SPREAD"
    assert pb == [{("GPU" if k == "TPU" else k): v for k, v in b.items()}
                  for b in jb]


def test_slice_bundles_default_eight_cards_a_host(monkeypatch):
    import ray_tpu_torch.core.placement as tplace

    seen = []
    monkeypatch.setattr(tplace, "placement_group",
                        lambda bundles, strategy="PACK": seen.append(
                            (bundles, strategy)))
    gpu.slice_placement_group("h100-16")
    assert seen == [([{"GPU": 8.0, "CPU": 1.0}] * 2, "STRICT_SPREAD")]


def _node_of_worker():
    from ray_tpu_torch.core.runtime import get_core_worker

    return get_core_worker().node_id.hex()


@pytest.mark.timeout_s(120)
def test_slice_placement_group_reserves_two_hosts(torch_two_gpu_nodes):
    """A live 16-card slice on two 8-card nodes: one bundle on each, and
    every card of the cluster reserved."""
    import ray_tpu_torch as rt

    pg = gpu.slice_placement_group("h100-16")
    assert pg.ready(timeout=60)
    probe = rt.remote(_node_of_worker)
    nodes = rt.get([probe.options(
        num_cpus=1, scheduling_strategy=rt.PlacementGroupSchedulingStrategy(
            pg, placement_group_bundle_index=i)).remote() for i in range(2)],
        timeout=60)
    assert len(set(nodes)) == 2
    assert rt.available_resources().get("GPU", 0.0) == 0.0
    rt.remove_placement_group(pg)


@pytest.fixture
def torch_two_gpu_nodes():
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=False)
    try:
        for _ in range(2):
            cluster.add_node(num_cpus=2, resources={"GPU": 8})
        cluster.wait_for_nodes(30)
        rt.init(address=cluster.address)
        yield cluster
    finally:
        if rt.is_initialized():
            rt.shutdown()
        cluster.shutdown()


def test_detect_chip_count_without_a_card(monkeypatch):
    def no_smi(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(subprocess, "run", no_smi)
    assert gpu.detect_chip_count() == (0, None) == api.detect_gpus()
    assert gpu.device_kind() is None


def test_detect_chip_count_reads_nvidia_smi(monkeypatch):
    listing = ("GPU 0: NVIDIA H100 80GB HBM3 (UUID: GPU-aaaa)\n"
               "GPU 1: NVIDIA H100 80GB HBM3 (UUID: GPU-bbbb)\n")

    def fake_run(cmd, **kw):
        assert cmd == ["nvidia-smi", "-L"]
        return subprocess.CompletedProcess(cmd, 0, stdout=listing,
                                           stderr="")

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert gpu.detect_chip_count() == (2, "NVIDIA H100 80GB HBM3")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1")
    assert gpu.detect_chip_count() == (1, "NVIDIA H100 80GB HBM3") == \
        api.detect_gpus()
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert gpu.detect_chip_count() == (0, None)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert gpu.device_kind() == "NVIDIA H100 80GB HBM3"
    assert gpu.peak_flops_per_chip() == 989e12


def test_device_kind_creates_no_cuda_context(monkeypatch):
    import torch

    monkeypatch.setattr(subprocess, "run", lambda *a, **k: (_ for _ in ())
                        .throw(FileNotFoundError("nvidia-smi")))
    before = torch.cuda.is_initialized()
    gpu.device_kind()
    assert torch.cuda.is_initialized() == before
