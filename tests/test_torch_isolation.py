"""The port stands alone: no file of ``ray_tpu_torch/`` (or
``chip_smoke.py``) imports ``jax`` or anything of ``ray_tpu``, importing
the package loads no JAX, nothing compiles at import, and the entry points
refuse to fall back to the CPU when no card is present."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "ray_tpu_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tests" / "torch_dist.py"]


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PORT.rglob("*.py"))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top == "jaxlib" or top == "ray_tpu"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_ray_tpu_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", "") == "__import__":
            bad += [a.value for a in node.args
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and _forbidden(a.value)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_loads_no_jax_and_builds_nothing():
    # The runtime's store library is built (at most once, under its file
    # lock) before the snapshot, so a test worker that opens a store
    # meanwhile cannot change _build/; the child still proves that the
    # imports load no native library and start no thread.
    from ray_tpu_torch._native.build import build_library

    build_library("shm_store", ["shm_store.cpp"])
    code = ("import importlib, sys, threading\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(k == 'ray_tpu' or k.startswith('ray_tpu.') "
            "for k in sys.modules), 'ray_tpu imported'\n"
            "from ray_tpu_torch._native import objstore\n"
            "assert objstore._lib is None, 'store library loaded'\n"
            "assert threading.active_count() == 1, threading.enumerate()\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    built = set((PORT / "_build").glob("*")) if (PORT / "_build").exists() \
        else set()
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    after = set((PORT / "_build").glob("*")) if (PORT / "_build").exists() \
        else set()
    assert after == built


def test_analyzer_loads_neither_torch_nor_jax_and_reads_its_own_baseline():
    """``ray_tpu_torch.analysis`` is pure stdlib: a run in a fresh
    interpreter loads no torch, no JAX and nothing of ``ray_tpu``, and its
    baseline is the port's own file."""
    code = ("import sys\n"
            "from ray_tpu_torch.analysis import DEFAULT_BASELINE, "
            "run_analysis\n"
            "run_analysis(select=['rpc-stub-drift'])\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(k == 'ray_tpu' or k.startswith('ray_tpu.') "
            "for k in sys.modules), 'ray_tpu imported'\n"
            "print(DEFAULT_BASELINE)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert Path(proc.stdout.strip()) == PORT / "analysis" / "baseline.json"


def test_models_package_imports_its_families_without_a_context():
    """In a fresh interpreter ``import ray_tpu_torch.models`` resolves
    ``models.llama`` and ``models.vit``, as ``ray_tpu.models`` does, and
    creates no CUDA context."""
    code = ("import ray_tpu_torch.models as m\n"
            "import torch\n"
            "assert m.llama.PRESETS['1b'].dim and m.vit.PRESETS['vit_b16']\n"
            "assert not torch.cuda.is_initialized()\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")


def test_entry_points_refuse_without_card(no_card):
    from ray_tpu_torch.models import llama, llama_decode
    from ray_tpu_torch.ops.optim import adamw
    from ray_tpu_torch.parallel import train_step
    from ray_tpu_torch.serve.decode import DecodeEngine, LlamaDecodeDeployment

    cfg = llama.PRESETS["debug"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama_decode.init_cache(cfg, 1, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaDecodeDeployment(config=cfg, slots=1, capacity=16)
    params = llama.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama_decode.generate(params, [[1, 2]], cfg, max_new_tokens=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(params, cfg, slots=1, capacity=16)
    # Speculative decoding and warmup: the same refusal.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(params, cfg, slots=1, capacity=16, page_tokens=16,
                     spec_draft_params=params, spec_draft_config=cfg,
                     spec_k=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaDecodeDeployment(config=cfg, slots=1, capacity=16,
                              kv_page_tokens=16, spec_draft_model="debug",
                              spec_k=2, warmup=True)
    # The train path: params, batches and steps follow the params' device,
    # which defaults to the card.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_params(cfg, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_step.init_sharded_params(
            lambda seed: llama.init_params(cfg, seed=seed),
            llama.param_axes(cfg), key=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_step.shard_batch({"tokens": torch.zeros(2, 9,
                                                      dtype=torch.long)})
    step = train_step.build_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg), adamw(1e-3))
    meta = {"w": torch.empty(2, device="meta")}
    with pytest.raises(ValueError, match="cuda or cpu"):
        step(meta, None, {})


@pytest.mark.parametrize("spec", ["2x4", "8", " 1X2 ", "7", "1"])
def test_decode_mesh_shape_parses_as_jax(spec):
    """The port's own copies of ``parse_topology`` and ``most_square``
    read a ``decode_mesh_shape`` as the JAX package does."""
    from ray_tpu.core import topology as jtopo
    from ray_tpu_torch.core import topology as ttopo

    assert ttopo.parse_topology(spec) == jtopo.parse_topology(spec)
    assert ttopo.parse_topology("2x4") == (2, 4)
    assert ttopo.parse_topology("8") == (2, 4)
    for chips in range(1, 13):
        assert ttopo.most_square(chips) == jtopo.most_square(chips)
    with pytest.raises(ValueError):
        ttopo.most_square(0)


def test_decode_mesh_shape_knob_builds_the_mesh():
    """An engine with no ``mesh_shape`` takes the knob's; a knob that asks
    for more ranks than the process group has raises, and nothing falls
    back to one device."""
    import torch.distributed as dist

    from ray_tpu_torch.core.config import config as rt_config
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.mesh import init_distributed
    from ray_tpu_torch.serve.decode import DecodeEngine

    cfg = llama.PRESETS["debug"]
    params = llama.init_params(cfg, device="cpu")
    init_distributed(0, 1, device_type="cpu")
    try:
        rt_config.decode_mesh_shape = "1"
        eng = DecodeEngine(params, cfg, slots=2, capacity=32, device="cpu")
        assert eng.stats()["mesh_shape"] == [1, 1]
        eng.shutdown()
        rt_config.decode_mesh_shape = "2x4"
        with pytest.raises(ValueError, match="needs 8 ranks"):
            DecodeEngine(params, cfg, slots=2, capacity=32, device="cpu")
    finally:
        rt_config.decode_mesh_shape = ""
        dist.destroy_process_group()


def test_rl_imports_and_trains_multi_agent_ppo_without_gymnasium(tmp_path):
    """``import ray_tpu_torch.rl`` and a multi-agent PPO iteration need no
    gymnasium (the card's machine has none): blocked in the driver through
    ``sys.modules`` and in the runners' processes by a package on their
    path that refuses to import."""
    shadow = tmp_path / "gymnasium"
    shadow.mkdir()
    (shadow / "__init__.py").write_text(
        "raise ImportError('gymnasium is blocked in this test')\n")
    code = ("import sys\n"
            "sys.modules['gymnasium'] = None\n"
            "import ray_tpu_torch as rt\n"
            "import ray_tpu_torch.rl as rl\n"
            "rt.init(num_cpus=2)\n"
            "try:\n"
            "    algo = rl.MultiAgentPPOConfig(num_env_runners=1,\n"
            "        episodes_per_sample=2, device='cpu').build()\n"
            "    m = algo.train()\n"
            "    assert m['env_steps_this_iter'] == 24, m\n"
            "    algo.stop()\n"
            "finally:\n"
            "    rt.shutdown()\n"
            "assert sys.modules['gymnasium'] is None\n"
            "try:\n"
            "    import gymnasium  # noqa: F401\n"
            "except ImportError:\n"
            "    print('blocked')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = f"{tmp_path}{os.pathsep}{ROOT}"
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=150)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("blocked")


def test_rl_algorithms_refuse_without_card(no_card):
    """Each algorithm's ``build()`` raises before it probes an env (the
    env names here do not exist) or starts a runner."""
    from ray_tpu_torch.rl import (APPOConfig, BCConfig, CQLConfig,
                                  DQNConfig, IMPALAConfig,
                                  MultiAgentPPOConfig, PPOConfig, SACConfig)

    for cls in (PPOConfig, IMPALAConfig, APPOConfig, DQNConfig, SACConfig,
                BCConfig, CQLConfig):
        assert cls().device == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(env="NoSuchEnv-v0").build()
    assert MultiAgentPPOConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiAgentPPOConfig(env="no/SuchEnv-v0").build()


def test_distributed_rl_and_gang_refuse_without_card(no_card):
    """The distributed learners' ``build()`` raises before it probes an env
    (the env names here do not exist) or starts an actor; so do a policy
    inference service and a learner state asked for the card."""
    from ray_tpu_torch.rl import DQNConfig, IMPALAConfig
    from ray_tpu_torch.rl.distributed import LearnerState, PolicyInference

    for cfg in (IMPALAConfig(env="NoSuchEnv-v0", distributed=True),
                IMPALAConfig(env="NoSuchEnv-v0").distributed_rollouts(2),
                DQNConfig(env="NoSuchEnv-v0").distributed_rollouts(
                    2, mode="inference")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cfg.build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PolicyInference((4,), 2, "k")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LearnerState("k")


def test_pipeline_plane_refuses_without_card(no_card):
    """``PipelinePlane`` runs its stages on the card unless told otherwise:
    without one it raises before it reserves a sub-slice (no runtime is
    up here, so reaching the reservation would fail differently), and so
    do the in-process baseline and a stage worker asked for the card."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.pipeline import make_stage_worker
    from ray_tpu_torch.train import PipelinePlane
    from ray_tpu_torch.train.pipeline_plane import single_process_baseline

    cfg = llama.PRESETS["debug"]
    params = llama.init_params(cfg, device="cpu", dtype=torch.float32)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PipelinePlane(cfg, params, n_stages=2, n_microbatches=2,
                          device=device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        single_process_baseline(cfg, params, 1e-3, [])
    worker = make_stage_worker(cfg, 0, 2, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker(torch.zeros((1, 4), dtype=torch.int32))
