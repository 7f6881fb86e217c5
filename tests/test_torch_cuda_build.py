"""``cuda_build.load``, which every kernel launch calls: a loaded library
is reused with no file-system call, and each source directory keeps its
own library (an A/B timing loads two versions of one kernel)."""

from pathlib import Path

from ray_tpu_torch.ops import cuda_build


def _refuse(*args, **kwargs):
    raise AssertionError("file-system work on a load that was cached")


def test_load_reuses_a_loaded_library_without_file_system_calls(
        monkeypatch, tmp_path):
    lib = object()
    monkeypatch.setitem(cuda_build._loaded, f"{tmp_path}/flash_fwd", lib)
    monkeypatch.setattr(cuda_build, "build", _refuse)
    monkeypatch.setattr(Path, "resolve", _refuse)
    assert cuda_build.load("flash_fwd", tmp_path) is lib


def test_load_builds_once_per_source_directory(monkeypatch, tmp_path):
    built, opened = [], []

    def build(names, csrc):
        built.append((list(names), str(csrc)))
        return [Path(csrc) / f"lib{names[0]}.so"]

    def cdll(path):
        opened.append(path)
        return ("lib", path)

    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "build", build)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", cdll)
    parent, change = tmp_path / "parent", tmp_path / "change"
    a = cuda_build.load("flash_fwd", parent)
    b = cuda_build.load("flash_fwd", change)
    assert a != b
    assert cuda_build.load("flash_fwd", parent) is a
    assert cuda_build.load("flash_fwd", change) is b
    assert built == [(["flash_fwd"], str(parent)),
                     (["flash_fwd"], str(change))]
    assert len(opened) == 2
