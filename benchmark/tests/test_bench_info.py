"""The result line's ``info``: the set-up split, the page pool's size and
peaks in bytes, and the mark of a run that built its kernels."""

from benchmark.drivers.common import setup_parts
from benchmark.drivers.engine import pool_info
from benchmark.harness import result, spec


def test_setup_parts_split_setup_s_at_each_mark():
    parts = setup_parts(10.0, {"imports": 16.5, "weights": 17.0}, 30.25)
    assert parts == {"imports": 6.5, "weights": 0.5, "to_window": 13.25}
    assert sum(parts.values()) == 30.25 - 10.0


def test_pool_bytes_follow_the_configuration():
    cell = spec.load_cell("mistral-7b.chat")
    info = pool_info(cell.config, cell.traffic,
                     {"pages_total": 4608, "pages_in_use": 1500,
                      "live_pages": 1000, "active": 44})
    # 2 (keys, values) x 32 layers x 8 KV heads x 128 x 2 bytes a token.
    page = 64 * 131072
    assert info["kv_pool_bytes"] == 4608 * page == 38654705664
    assert info["kv_live_bytes_peak"] == 1000 * page
    assert info["kv_pages_peak"] == 1500 and info["active_peak"] == 44
    assert pool_info(cell.config, cell.traffic,
                     {"pages_total": None}) == {}


def test_a_new_file_in_the_build_directory_marks_a_build(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(result, "CACHE_DIRS", (tmp_path / "_build",
                                               tmp_path / "none"))
    (tmp_path / "_build").mkdir()
    (tmp_path / "_build" / "libold.so").write_bytes(b"x")
    before = result.cache_files()
    assert len(result.cache_files() - before) == 0
    (tmp_path / "_build" / "libnew.so").write_bytes(b"y")
    assert len(result.cache_files() - before) == 1
