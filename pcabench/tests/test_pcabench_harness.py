"""The harness finds every file by the name BENCHMARK.json gives it and
refuses an unknown one."""
import json

import pytest

import small
from pcabench import harness

BENCH = json.loads((small.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("kind,name", [
    ("configs", "mnist-28x28"), ("configs", "serve-t64"),
    ("traffic", "fit_closed"), ("traffic", "serve_mixed"),
    ("metrics", "flush_fill.serve"), ("drivers", "serve_closed")])
def test_finds_a_file_by_name(kind, name):
    assert harness.find(kind, name).is_file()


@pytest.mark.parametrize("kind", sorted(harness.KINDS))
def test_refuses_an_unknown_name(kind):
    with pytest.raises(harness.Refused):
        harness.find(kind, "no-such-name")
    with pytest.raises(harness.Refused):
        harness.find(kind, "../BENCHMARK")


def test_refuses_an_unknown_workload():
    with pytest.raises(harness.Refused):
        harness.resolve(BENCH, "fit.unknown", 1)


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_with_its_metrics(w):
    cell = harness.resolve(BENCH, w, 3)
    harness.load_module("drivers", cell.traffic["driver"])
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(harness.load_module("metrics", m["name"]).read)
    assert cell.config["checks"]


def test_every_metric_and_config_file_is_named_in_the_benchmark():
    per_layer = {m["name"] for m in BENCH["per_layer"]}
    files = {p.name[:-3] for p in (harness.BENCH / "metrics").glob("*.py")}
    assert files == per_layer
    for c in BENCH["configs"]:
        assert (small.ROOT / c["file"]).is_file()
        assert json.loads((small.ROOT / c["file"]).read_text())["name"] == \
            c["name"]


def test_a_per_layer_metric_without_workloads_follows_its_moves():
    bench = dict(BENCH, per_layer=BENCH["per_layer"] + [
        {"name": "extra", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "device", "moves": "fit_s"}])
    fit = harness.resolve(bench, "fit.mnist-28x28", 1)
    serve = harness.resolve(bench, "serve.small", 1)
    assert "extra" in {m["name"] for m in fit.per_layer}
    assert "extra" not in {m["name"] for m in serve.per_layer}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torchish", types.ModuleType("x"))
    assert "repro_torchish" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["repro.core"]


def test_no_card_exits_2_without_a_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "serve.small", "--seed", "5",
                       "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == harness.EXIT_NO_CARD and out.out == ""
    assert "is_available" in out.err


def test_serve_window_closes_once_every_request_sent_is_back():
    from pcabench import tracing
    cell = small.small_cell("serve.mixed", 5)
    driver = harness.load_module("drivers", cell.traffic["driver"])
    state = driver.prepare(cell)
    with tracing.Recorder(False) as rec:
        m = driver.measure(cell, state, 0.3, rec)
    assert m.missing == 0 and m.attempted > 0
    assert m.window_s >= 0.3
    assert m.e2e["requests_per_s"] * m.window_s == \
        pytest.approx(m.attempted)
    view = harness.View(cell, m)
    read = harness.load_module("metrics", "latency_p95_ms.mixed").read
    assert read(view) == m.e2e["latency_p95_ms"] > 0
    m.e2e["latency_p95_ms"] = float("nan")
    assert read(view) is None
