"""The idle share is one less the union of the device intervals: copies
and kernels that overlap count once."""
import pytest

import small  # noqa: F401
from pcabench import tracing


def test_union_of_overlapping_intervals():
    iv = [(0.0, 2.0), (1.0, 3.0), (2.5, 4.0), (6.0, 7.0), (6.5, 6.8)]
    assert tracing.union_length(iv) == pytest.approx(5.0)
    assert tracing.union_length(iv, 1.5, 6.5) == pytest.approx(3.0)
    assert tracing.merged(iv) == [(0.0, 4.0), (6.0, 7.0)]


def synthetic_trace():
    ev = tracing.Event
    device = [ev("void (anonymous namespace)::gram_kernel<float>(float*)",
                 1.0, 3.0),
              ev("Memcpy HtoD (Pinned -> Device)", 2.0, 4.0),  # overlaps
              ev("sweep_grid_kernel(float const*)", 5.0, 6.0),
              ev("sweep_grid_kernel(float const*)", 9.0, 9.5),
              ev("void at::native::reduce_kernel<512>(int)", 9.5, 9.6)]
    host = [ev(tracing.WINDOW, 0.0, 10.0), ev("pcabench.submit", 4.0, 5.5),
            ev("aten::copy_", 4.2, 4.4), ev("pcabench.poll", 6.0, 9.0)]
    return tracing.Trace(device, host, (0.0, 10.0))


def test_idle_share_counts_overlap_once():
    tr = synthetic_trace()
    assert tr.busy_s() == pytest.approx(3.0 + 1.0 + 0.6)
    assert tr.window_s == 10.0


def test_breakdown_names_gaps_by_the_host():
    out = synthetic_trace().breakdown()
    gaps = [(n, pytest.approx(s)) for n, s in out["idle_gaps"]]
    assert gaps == [("pcabench.poll > python", 3.0),     # 6.0 .. 9.0
                    ("window > python", 1.0),            # 0.0 .. 1.0
                    ("pcabench.submit > python", 1.0),   # 4.0 .. 5.0
                    ("window > python", 0.4)]            # 9.6 .. 10.0
    ops = dict(out["device_ops"])
    assert ops["sweep_grid_kernel"] == pytest.approx(1.5)


def test_kernels_are_matched_by_whole_name():
    tr = synthetic_trace()
    assert len(tr.in_window("sweep_grid_kernel")) == 2
    assert len(tr.in_window("gram_kernel")) == 1
    assert tr.in_window("reduce_kernel") == []
