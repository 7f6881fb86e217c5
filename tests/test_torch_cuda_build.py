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


def test_artifact_follows_the_headers_a_source_includes(tmp_path):
    """Editing a header that a kernel includes (directly or through another
    header) changes its build's path, so the kernel is rebuilt; a header it
    does not include does not."""
    (tmp_path / "kern.cu").write_text('#include "hopper.cuh"\nint x;\n')
    (tmp_path / "hopper.cuh").write_text('#include "inner.cuh"\nint y;\n')
    (tmp_path / "inner.cuh").write_text("int z;\n")
    (tmp_path / "other.cuh").write_text("int w;\n")
    first = cuda_build._artifact("kern", tmp_path)
    assert cuda_build._artifact("kern", tmp_path) == first
    (tmp_path / "other.cuh").write_text("int w2;\n")
    assert cuda_build._artifact("kern", tmp_path) == first
    (tmp_path / "hopper.cuh").write_text('#include "inner.cuh"\nint y2;\n')
    second = cuda_build._artifact("kern", tmp_path)
    assert second != first
    (tmp_path / "inner.cuh").write_text("int z2;\n")
    assert cuda_build._artifact("kern", tmp_path) not in (first, second)
    assert [p.name for p in cuda_build._sources("kern", tmp_path)] == [
        "kern.cu", "hopper.cuh", "inner.cuh"]


def test_every_kernel_source_hashes_the_shared_header():
    for name in ("flash_fwd", "flash_bwd", "splash"):
        names = [p.name for p in cuda_build._sources(name, cuda_build.CSRC)]
        assert names == [f"{name}.cu", "hopper.cuh"], names


def test_delta_source_stands_alone(tmp_path):
    """``delta.cu`` (the backward's delta pre-pass) includes no header of
    ``csrc``: its build follows its own text and not ``hopper.cuh``'s.
    Every ``.cu`` in ``csrc`` is one of the four kernel sources."""
    assert sorted(p.stem for p in cuda_build.CSRC.glob("*.cu")) == [
        "delta", "flash_bwd", "flash_fwd", "splash"]
    assert [p.name for p in cuda_build._sources("delta", cuda_build.CSRC)
            ] == ["delta.cu"]
    text = (cuda_build.CSRC / "delta.cu").read_text()
    (tmp_path / "delta.cu").write_text(text)
    (tmp_path / "hopper.cuh").write_text("int y;\n")
    first = cuda_build._artifact("delta", tmp_path)
    (tmp_path / "hopper.cuh").write_text("int y2;\n")
    assert cuda_build._artifact("delta", tmp_path) == first
    (tmp_path / "delta.cu").write_text(text + "\n")
    assert cuda_build._artifact("delta", tmp_path) != first
