"""The trace reduction on hand-made profiler events: busy time as the
union of device intervals, a range's device span, idle gaps labelled by
the host operation open in them, all clipped to the counted part."""

from types import SimpleNamespace as NS

import pytest
import torch

from benchmark.harness.trace import reduce_events

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _ev(name, dev, start, end, ua=False):
    return NS(name=name, device_type=dev, is_user_annotation=ua,
              time_range=NS(start=start, end=end))


def test_reduce_clips_unions_and_labels():
    events = [
        _ev("bench::origin", CPU, 1000.0, 1001.0, ua=True),
        _ev("aten::mm", CPU, 1000.0, 1100.0),
        _ev("k1", CUDA, 1050.0, 1200.0),              # half before t0
        _ev("k2", CUDA, 1150.0, 1300.0),              # overlaps k1
        _ev("aten::copy_", CPU, 1350.0, 1390.0),      # host during a gap
        _ev("k3", CUDA, 1400.0, 1500.0),
        _ev("bench::flash_fwd", CPU, 1390.0, 1395.0, ua=True),
        _ev("bench::flash_fwd", CUDA, 1400.0, 1450.0, ua=True),
        _ev("k4", CUDA, 1700.0, 1800.0),              # after t1
    ]
    # Host clock: origin at 10.0 s is trace time 1000 us; count 1100-1600.
    out = reduce_events(events, 10.0, 10.0 + 100e-6, 10.0 + 600e-6,
                        ["flash_fwd"], {"flash_fwd": [{"b": 1}]})
    assert out["window_s"] == pytest.approx(500e-6)
    # Busy: [1100, 1300] and [1400, 1500] = 300 us.
    assert out["busy_s"] == pytest.approx(300e-6)
    assert out["ranges"]["flash_fwd"]["device_s"] == pytest.approx(50e-6)
    assert out["ranges"]["flash_fwd"]["calls"] == [{"b": 1}]
    gaps = dict(map(tuple, out["breakdown"]["idle_gaps"]))
    assert gaps == {"aten::copy_": pytest.approx(100e-6)}
    ops = dict(map(tuple, out["breakdown"]["device_ops"]))
    assert ops["k1"] == pytest.approx(100e-6) and "k4" not in ops
