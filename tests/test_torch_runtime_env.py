"""The port's runtime environments (``ray_tpu_torch.runtime_env``) and job
submission (``ray_tpu_torch.job_submission``) on the CPU: the runtime_env
and job cases of ``tests/test_jobs_and_envs.py`` with the port in place of
the JAX package, and parity cases that put the same inputs through both
packages' functions (``normalize`` on good and bad specs, the working_dir
package, the pip env key, the node's env hash, ``gc_envs``' eviction
order). The port's envs live under ``ray_tpu_torch_envs`` in the temp
directory (``tempfile.gettempdir()``)."""

import os
import shutil
import tempfile
import time
import zipfile

import pytest
from test_jobs_and_envs import _make_wheel

import ray_tpu_torch as rt


@pytest.fixture
def torch_regular():
    core = rt.init(num_cpus=4)
    yield core
    rt.shutdown()


def test_runtime_env_vars(torch_regular):
    @rt.remote(runtime_env={"env_vars": {"MY_FLAG": "42"}})
    def read_flag():
        return os.environ.get("MY_FLAG")

    @rt.remote
    def read_plain():
        return os.environ.get("MY_FLAG")

    assert rt.get(read_flag.remote(), timeout=60) == "42"
    assert rt.get(read_plain.remote(), timeout=60) is None


def test_runtime_env_working_dir(torch_regular, tmp_path):
    pkg = tmp_path / "proj"
    pkg.mkdir()
    (pkg / "mymod.py").write_text("VALUE = 'from-working-dir'\n")
    from ray_tpu_torch.runtime_env import ENV_ROOT, upload_working_dir

    uri = upload_working_dir(str(pkg))
    assert uri.startswith("kv://")

    @rt.remote(runtime_env={"working_dir": uri})
    def use_mod():
        import mymod

        return mymod.VALUE, os.getcwd()

    value, cwd = rt.get(use_mod.remote(), timeout=120)
    assert value == "from-working-dir"
    assert ENV_ROOT == os.path.join(tempfile.gettempdir(), "ray_tpu_torch_envs")
    assert os.path.dirname(cwd) == os.path.realpath(ENV_ROOT)


def test_actor_runtime_env(torch_regular):
    @rt.remote(runtime_env={"env_vars": {"ACTOR_FLAG": "on"}})
    class EnvActor:
        def flag(self):
            return os.environ.get("ACTOR_FLAG")

    a = EnvActor.remote()
    assert rt.get(a.flag.remote(), timeout=60) == "on"


def test_job_submission_lifecycle(torch_regular, tmp_path):
    from ray_tpu_torch.job_submission import JobSubmissionClient

    script = tmp_path / "entry.py"
    script.write_text("print('hello from job'); import sys; sys.exit(0)\n")
    client = JobSubmissionClient()
    job_id = client.submit_job(entrypoint=f"python {script}")
    status = client.wait_until_finished(job_id, timeout=120)
    assert status == "SUCCEEDED"
    assert "hello from job" in client.get_job_logs(job_id)
    assert client.list_jobs()[job_id]["state"] == "SUCCEEDED"


def test_job_failure_reported(torch_regular, tmp_path):
    from ray_tpu_torch.job_submission import JobSubmissionClient

    script = tmp_path / "bad.py"
    script.write_text("raise SystemExit(3)\n")
    client = JobSubmissionClient()
    job_id = client.submit_job(entrypoint=f"python {script}")
    assert client.wait_until_finished(job_id, timeout=120) == "FAILED"


@pytest.mark.timeout_s(240)
@pytest.mark.slow  # as the reference's: a real pip wheel build
def test_runtime_env_pip_wheel_isolated(torch_regular, tmp_path):
    """A task whose runtime_env pips in a wheel absent from the base env
    imports it (torch still inherited from the base); a plain task cannot,
    and same-env tasks reuse one worker."""
    whl = tmp_path / "envprobe_pkg-0.1-py3-none-any.whl"
    _make_wheel(str(whl), "envprobe_pkg", "0.1", "MAGIC = 'from-wheel'\n")

    @rt.remote
    def probe():
        import envprobe_pkg
        import torch

        return envprobe_pkg.MAGIC, os.getpid(), torch.__version__

    env = {"pip": [str(whl)]}
    magic, pid1, version = rt.get(
        probe.options(runtime_env=env).remote(), timeout=240)
    assert magic == "from-wheel"
    import torch

    assert version == torch.__version__
    _, pid2, _ = rt.get(probe.options(runtime_env=env).remote(), timeout=120)
    assert pid1 == pid2  # same env hash -> pooled worker reused

    @rt.remote
    def probe_base():
        try:
            import envprobe_pkg  # noqa: F401

            return "leaked"
        except ImportError:
            return "isolated"

    assert rt.get(probe_base.remote(), timeout=60) == "isolated"


def test_runtime_env_pip_failure_surfaces(torch_regular):
    """A broken pip spec fails the lease, and the task's error says why."""
    @rt.remote
    def never():
        return 1

    ref = never.options(
        max_retries=0,
        runtime_env={"pip": ["/nonexistent/definitely-missing.whl"]},
    ).remote()
    with pytest.raises(Exception, match="pip|lease|worker start"):
        rt.get(ref, timeout=120)


def test_runtime_env_py_modules_local_and_kv(torch_regular, tmp_path):
    """py_modules via a local package dir and via a kv:// upload both land
    on the worker's import path."""
    pkg = tmp_path / "kvmod"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("WHO = 'kvmod-local'\n")

    @rt.remote
    def who():
        import kvmod

        return kvmod.WHO

    env = {"py_modules": [str(pkg)]}
    assert rt.get(who.options(runtime_env=env).remote(),
                  timeout=120) == "kvmod-local"

    from ray_tpu_torch.runtime_env import upload_py_module

    (pkg / "__init__.py").write_text("WHO = 'kvmod-kv'\n")
    uri = upload_py_module(str(pkg))
    assert uri.startswith("kv://")
    assert rt.get(who.options(runtime_env={"py_modules": [uri]}).remote(),
                  timeout=120) == "kvmod-kv"


def test_runtime_env_rejects_unknown_keys(torch_regular):
    @rt.remote
    def f():
        return 1

    with pytest.raises(ValueError, match="unsupported runtime_env"):
        f.options(runtime_env={"conda": {"deps": []}}).remote()
    with pytest.raises(ValueError, match="pip"):
        f.options(runtime_env={"pip": "not-a-list"}).remote()


def _env_dirs(root, now):
    """The eviction case's dirs under ``root``: name -> path."""
    def mk(name, kb, ready=True, age=0):
        d = os.path.join(root, name)
        os.makedirs(d)
        with open(os.path.join(d, "blob"), "wb") as f:
            f.write(b"x" * kb * 1024)
        if ready:
            marker = os.path.join(d, ".ready")
            with open(marker, "w") as f:
                f.write("ok")
            os.utime(marker, (now - age, now - age))
        return d

    return {"old": mk("old", 64, age=600), "older": mk("older", 32, age=700),
            "pinned": mk("pinned", 64, age=500),
            "live_pinned": mk("live_pinned", 64, age=400),
            "mid": mk("mid", 16, age=350), "fresh": mk("fresh", 64, age=0),
            "half": mk("half", 64, ready=False)}


def test_runtime_env_gc_evicts_lru_not_pinned(tmp_path):
    """gc_envs removes least-recently-used ready dirs past the budget but
    never touches pinned (live-worker) or half-built dirs."""
    from ray_tpu_torch.runtime_env import gc_envs, pin_env_dir

    root = str(tmp_path / "envs")
    os.makedirs(root)
    d = _env_dirs(root, time.time())
    pin_env_dir(d["live_pinned"], "w" * 8, os.getpid())

    evicted = gc_envs(budget_bytes=250 * 1024, in_use={d["pinned"]},
                      root=root, min_age_s=120.0)
    # LRU first, skipping the in-use and live-pinned dirs; "fresh" is too
    # young, "half" has no .ready marker.
    assert evicted == [os.path.abspath(d["older"]), os.path.abspath(d["old"])]
    for name in ("pinned", "live_pinned", "mid", "fresh", "half"):
        assert os.path.exists(d[name]), name


def test_runtime_env_gc_end_to_end(torch_regular, tmp_path):
    """A worker's env dirs stay pinned while it lives; after the env is
    unused, a tiny budget evicts it and a later lease rebuilds it."""
    from ray_tpu_torch.core import api as api_mod
    from ray_tpu_torch.core.runtime import get_core_worker
    from ray_tpu_torch.runtime_env import (gc_envs, materialize_working_dir,
                                           upload_working_dir)

    proj = tmp_path / "proj"
    proj.mkdir()
    (proj / "marker.txt").write_text("v1")
    uri = upload_working_dir(str(proj))

    @rt.remote
    def read_marker():
        with open("marker.txt") as f:
            return f.read()

    assert rt.get(read_marker.options(
        runtime_env={"working_dir": uri}).remote(), timeout=120) == "v1"
    node = api_mod._local_cluster[1]
    env_dir = materialize_working_dir(uri, get_core_worker().controller)
    assert os.path.exists(os.path.join(env_dir, ".ready"))

    with node._lock:
        pinned = {d for h in node._workers.values() for d in h.env_dirs}
    assert env_dir in pinned
    others = {os.path.join(os.path.dirname(env_dir), n)
              for n in os.listdir(os.path.dirname(env_dir))} - {env_dir}
    gc_envs(0, others, min_age_s=0.0)
    assert os.path.exists(env_dir)

    with node._lock:
        victims = [h for h in node._workers.values()
                   if env_dir in h.env_dirs]
    for h in victims:
        node.kill_worker(h.worker_id.binary(), True)
    gc_envs(0, others, min_age_s=0.0)
    assert not os.path.exists(env_dir)

    assert rt.get(read_marker.options(
        runtime_env={"working_dir": uri}).remote(), timeout=120) == "v1"


def test_image_uri_plugin_dir_backing(torch_regular, tmp_path):
    """image_uri seam: dir:// roots the worker in the unpacked image (cwd
    + site-packages on the path); docker:// fails the lease clearly."""
    image = tmp_path / "img"
    (image / "site-packages").mkdir(parents=True)
    (image / "etc").mkdir()
    (image / "etc" / "tag.txt").write_text("img-v7")
    (image / "site-packages" / "imgmod.py").write_text(
        "VALUE = 'from-image'\n")

    @rt.remote
    def inspect():
        import imgmod  # noqa: F401 - from the image's site-packages

        with open("etc/tag.txt") as f:
            return imgmod.VALUE, f.read(), os.environ.get(
                "RAY_TPU_IMAGE_URI")

    uri = f"dir://{image}"
    value, tag, env_uri = rt.get(inspect.options(
        runtime_env={"image_uri": uri}).remote(), timeout=120)
    assert value == "from-image" and tag == "img-v7" and env_uri == uri

    @rt.remote
    def nope():
        return 1

    with pytest.raises(Exception, match="container runtime"):
        rt.get(nope.options(
            runtime_env={"image_uri": "docker://python:3.12"}).remote(),
            timeout=60)


# ------------------------------------------------ parity with ray_tpu

SPECS = [
    {},
    {"env_vars": {"A": 1, "B": "x"}},
    {"env_vars": {}, "pip": [], "working_dir": ""},
    {"working_dir": "/some/dir"},
    {"working_dir": "kv://__pkg__/abc.zip", "py_modules": ("m1", "kv://m2")},
    {"pip": ["numpy==1.26", "/a/b.whl"]},
    {"image_uri": "dir:///img"},
    {"image_uri": "docker://python:3.12", "env_vars": {"K": "v"}},
    {"conda": {"deps": []}},
    {"pip": "not-a-list"},
    {"pip": ["ok", 3]},
    {"py_modules": "not-a-list"},
    {"image_uri": "no-scheme"},
    {"env_vars": {"A": "1"}, "container": {}, "conda": 1},
]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — compared by class and text
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("spec", SPECS, ids=range(len(SPECS)))
def test_normalize_matches_jax(spec):
    from ray_tpu import runtime_env as jre
    from ray_tpu_torch import runtime_env as tre

    assert _outcome(tre.normalize, spec) == _outcome(jre.normalize, spec)


def test_package_working_dir_matches_jax(tmp_path):
    from ray_tpu import runtime_env as jre
    from ray_tpu_torch import runtime_env as tre

    root = tmp_path / "tree"
    for rel, data in {"a.py": "A = 1\n", "pkg/__init__.py": "",
                      "pkg/b.txt": "bee" * 100, "pkg/sub/c.bin": "\x00\x01",
                      "__pycache__/x.pyc": "skip", ".git/HEAD": "skip",
                      "node_modules/y.js": "skip"}.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(data)
    import io

    for prefix in ("", "named"):
        zips = [zipfile.ZipFile(io.BytesIO(mod.package_working_dir(
            str(root), arcname_prefix=prefix))) for mod in (tre, jre)]
        names = [z.namelist() for z in zips]
        assert names[0] == names[1]
        assert len(names[0]) == 4
        assert all("__pycache__" not in n and ".git" not in n
                   for n in names[0])
        for n in names[0]:
            assert zips[0].read(n) == zips[1].read(n)


def test_pip_env_key_and_node_env_hash_match_jax():
    from ray_tpu import runtime_env as jre
    from ray_tpu.core import node as jnode
    from ray_tpu_torch import runtime_env as tre
    from ray_tpu_torch.core import node as tnode

    for pip in (["numpy"], ["b", "a"], ["/x/y.whl", "z==1.0"]):
        t, j = tre.pip_env_dir(pip), jre.pip_env_dir(pip)
        assert os.path.basename(t) == os.path.basename(j)
        assert os.path.dirname(t) == tre.ENV_ROOT
        assert os.path.dirname(j) == jre.ENV_ROOT != tre.ENV_ROOT
    for spec in SPECS[:8] + [None]:
        norm = tre.normalize(spec) if spec else spec
        assert tnode._runtime_env_hash(norm) == jnode._runtime_env_hash(norm)


def test_gc_eviction_order_matches_jax(tmp_path):
    from ray_tpu import runtime_env as jre
    from ray_tpu_torch import runtime_env as tre

    now = time.time()
    evicted = {}
    for name, mod in (("torch", tre), ("jax", jre)):
        root = str(tmp_path / name)
        os.makedirs(root)
        d = _env_dirs(root, now)
        mod.pin_env_dir(d["live_pinned"], "p" * 8, os.getpid())
        evicted[name] = [os.path.basename(p) for p in mod.gc_envs(
            budget_bytes=100 * 1024, in_use={d["pinned"]}, root=root,
            min_age_s=120.0)]
        left = sorted(os.listdir(root))
        evicted[name].append(left)
        shutil.rmtree(root)
    assert evicted["torch"] == evicted["jax"]
    assert evicted["torch"][:3] == ["older", "old", "mid"]
