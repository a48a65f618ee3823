"""The four metrics that read the program's ``repro.*`` ranges, on a
synthetic trace: the means, the rooflines' bound weighted by sweeps across
two shapes, None with no range or no kernel, and nothing outside the
window counted."""
import types

import pytest

import small  # noqa: F401
from pcabench import counts, harness, ranges, tracing

ev = tracing.Event
SMEM = "repro.launch:eigh:128x128:30/32:n128:s50:smem"
SMEM_SVD = "repro.launch:svd:512x128:32/32:n128:s50:smem"
GRID = "repro.launch:pca:1024x256:2/32:n256:s50:grid"
GRID_FEW = "repro.launch:eigh:256x256:1/16:n256:s10:grid"


def read(metric, trace):
    view = types.SimpleNamespace(trace=trace)
    return harness.load_module("metrics", metric).read(view)


def synthetic_trace():
    """Window 0..10 s; ranges and kernels inside it and one of each kind
    before it (at -1) and after it (at 10)."""
    host = [ev(tracing.WINDOW, 0.0, 10.0),
            ev("repro.dispatch", 1.0, 1.5),
            ev("repro.stage", 1.1, 1.102),
            ev(SMEM, 1.2, 1.212),
            ev("repro.stage", 2.1, 2.106),
            ev(SMEM_SVD, 2.2, 2.218),
            ev("repro.stage", 3.1, 3.104),
            ev(GRID, 3.2, 3.215),
            ev(GRID_FEW, 4.2, 4.205),
            ev("repro.stage", -1.0, -0.5),
            ev(SMEM, -1.0, -0.5),
            ev(GRID, -1.0, -0.5),
            ev("repro.stage", 10.0, 11.0),
            ev(SMEM, 10.0, 11.0),
            ev("aten::copy_", 1.1, 1.1005)]
    device = [ev("sweep_smem_kernel(float*)", 5.0, 5.0004),
              ev("sweep_smem_kernel(float*)", 5.1, 5.1006),
              ev("sweep_grid_kernel(float const*)", 6.0, 6.004),
              ev("sweep_grid_kernel(float const*)", -1.0, -0.9),
              ev("sweep_smem_kernel(float*)", 10.0, 10.9)]
    return tracing.Trace(device, host, (0.0, 10.0))


def test_parse_reads_every_field():
    assert ranges.parse(GRID) == ranges.Launch(
        "pca", "1024x256", 2, 32, 256, 50, "grid")


def test_stage_and_launch_means_count_the_window_only():
    tr = synthetic_trace()
    assert read("stage_ms.serve", tr) == pytest.approx(
        1e3 * (0.002 + 0.006 + 0.004) / 3)
    assert read("launch_ms.serve", tr) == pytest.approx(
        1e3 * (0.012 + 0.018 + 0.015 + 0.005) / 4)


def test_smem_roofline_is_the_mean_bound_over_the_mean_kernel():
    bound = counts.bound_s(32 * counts.sweep_flops(128),
                           32 * counts.sweep_bytes(128), counts.PEAK_FP32)
    assert bound == pytest.approx(9.0e-6, rel=2e-3)  # flops, not bytes
    want = 100.0 * bound / 0.0005   # two launches of 0.4 and 0.6 ms
    assert read("smem_sweep_roofline.serve", synthetic_trace()) == \
        pytest.approx(want)


def test_grid_roofline_weights_each_shape_by_its_sweeps():
    b32 = counts.bound_s(32 * counts.sweep_flops(256),
                         32 * counts.sweep_bytes(256), counts.PEAK_FP32)
    b16 = counts.bound_s(16 * counts.sweep_flops(256),
                         16 * counts.sweep_bytes(256), counts.PEAK_FP32)
    mean = (50 * b32 + 10 * b16) / 60
    assert mean != pytest.approx((b32 + b16) / 2)
    assert read("grid_sweep_roofline.serve", synthetic_trace()) == \
        pytest.approx(100.0 * mean / 0.004)


@pytest.mark.parametrize("metric", ["stage_ms.serve", "launch_ms.serve",
                                    "smem_sweep_roofline.serve",
                                    "grid_sweep_roofline.serve"])
def test_none_without_ranges_or_trace(metric):
    tr = synthetic_trace()
    bare = tracing.Trace(tr.device, [e for e in tr.host
                                     if not e.name.startswith("repro.")],
                         tr.window)
    assert read(metric, bare) is None
    assert read(metric, None) is None


@pytest.mark.parametrize("metric,kernel", [
    ("smem_sweep_roofline.serve", "sweep_smem_kernel"),
    ("grid_sweep_roofline.serve", "sweep_grid_kernel")])
def test_roofline_none_without_its_kernel(metric, kernel):
    tr = synthetic_trace()
    tr.device = [e for e in tr.device if not tracing.is_kernel(e.name,
                                                                kernel)]
    assert read(metric, tr) is None


def test_roofline_none_without_a_range_of_its_kind():
    tr = synthetic_trace()
    tr.host = [e for e in tr.host if not e.name.endswith(":grid")]
    assert read("grid_sweep_roofline.serve", tr) is None
    assert read("smem_sweep_roofline.serve", tr) is not None
