"""The port's training host side against the reference's, on the CPU: the
token pipeline (``repro_torch.data``), the checkpointer, ``configs.shapes``,
``launch.accounting``, the watchdog and ``runtime.elastic``, the step
builders and the trainer CLI (``launch.train.main(..., device="cpu")``).

Contracts: the pipeline's tokens bitwise (integer); a checkpoint round
trip bitwise, bf16 leaves included, and the reference's on-disk layout
read both ways for the dtypes numpy has; the shape cells, ``applicable``
and ``input_specs`` equal; ``param_counts`` and ``model_flops`` equal,
and ``param_counts`` equal to the port model's weights (its ``numel``
less the norm parameters and the learned position table, which the
count leaves out); the watchdog held to the reference's own tests, on a
fake clock; the CLI's loss falling as the reference's test asks of its
own (25 steps: the last at least 0.5 below the first), a
preempt-and-resume run bitwise the uninterrupted one, and the CLI's
other exits (stall, SIGTERM) and refusals.
"""
import dataclasses
import json
import os
import signal
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import checkpointer as jckpt
from repro.configs import shapes as jshapes
from repro.data import DataConfig as JDataConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro.launch import accounting as jaccounting
from repro.runtime import watchdog as jwatchdog
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import checkpointer as tckpt
from repro_torch.configs import shapes as tshapes
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch import accounting as taccounting
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train
from repro_torch.models import transformer as ttfm
from repro_torch.runtime import elastic as telastic
from repro_torch.runtime import watchdog as twatchdog

DATA_CFGS = {
    "default": {},
    "zipf_flat": {"zipf_a": 2.5, "ngram_repeat": 1, "seed": 5},
    "long_ngram": {"seq_len": 100, "ngram_repeat": 16, "vocab_size": 50304},
    "batch16": {"global_batch": 16, "seq_len": 17, "seed": 3},
}
REDUCED = ["--arch", "olmo-1b", "--reduced", "--global-batch", "4",
           "--seq-len", "32", "--lr", "5e-3", "--log-every", "100"]


# -- data pipeline ------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(DATA_CFGS))
def test_pipeline_batches_bitwise(name):
    kw = DATA_CFGS[name]
    ref, port = JTokenPipeline(JDataConfig(**kw)), TokenPipeline(
        DataConfig(**kw))
    for step in (0, 1, 7, 1000):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_pipeline_host_shards_bitwise():
    kw = dict(seq_len=16, global_batch=8, vocab_size=64, seed=1)
    whole = TokenPipeline(DataConfig(**kw)).batch_at(7)
    for i in range(4):
        got = TokenPipeline(DataConfig(**kw), process_index=i,
                            process_count=4).batch_at(7)
        want = JTokenPipeline(JDataConfig(**kw), process_index=i,
                              process_count=4).batch_at(7)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, whole[2 * i:2 * i + 2])


def test_pipeline_memmap_source_bitwise(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 1000, 5000).astype(np.int32) \
        .tofile(path)
    kw = dict(seq_len=64, global_batch=4, source=str(path))
    ref, port = JTokenPipeline(JDataConfig(**kw)), TokenPipeline(
        DataConfig(**kw))
    for step in (0, 3, 40):
        np.testing.assert_array_equal(port.batch_at(step),
                                      ref.batch_at(step))


def test_pipeline_cursor_restores_as_the_reference():
    kw = dict(seq_len=32, global_batch=4, vocab_size=128, seed=3)
    ref, port = JTokenPipeline(JDataConfig(**kw)), TokenPipeline(
        DataConfig(**kw))
    for _ in range(3):
        np.testing.assert_array_equal(next(port), next(ref))
    assert port.state() == ref.state() == {"step": 3}
    resumed = TokenPipeline(DataConfig(**kw))
    resumed.restore(json.loads(json.dumps(port.state())))
    np.testing.assert_array_equal(next(resumed), next(ref))


# -- checkpointer ---------------------------------------------------------------

def _state(seed: int = 0):
    """A train-state-like tree: a module, dicts, a NamedTuple, a list, a
    None subtree, every dtype the trainer writes, a numpy array, an int."""
    from repro_torch.optim.adamw import OptState
    g = torch.Generator().manual_seed(seed)
    module = torch.nn.Linear(5, 3).to(torch.bfloat16)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return {
        "params": module,
        "opt": OptState(
            m={"w": torch.randn(3, 5, generator=g).to(torch.bfloat16)},
            v={"w": {"q": torch.randint(-127, 128, (3, 1, 128),
                                        generator=g).to(torch.int8),
                     "s": torch.rand(3, 1, 1, generator=g)}},
            count=torch.tensor(7, dtype=torch.int32)),
        "comp": {"q": [torch.randn(4, 2, generator=g, dtype=torch.float64),
                       None], "n": torch.arange(6)},
        "host": np.arange(4, dtype=np.float32) * seed,
        "step": 11 + seed,
    }


def _leaves(state):
    return dict(tckpt._flatten(state))


def _assert_bitwise(got, want):
    g, w = _leaves(got), _leaves(want)
    assert list(g) == list(w)
    for key in w:
        a, b = g[key], w[key]
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert torch.equal(a.view(torch.uint8) if a.dtype ==
                               torch.bfloat16 else a,
                               b.view(torch.uint8) if b.dtype ==
                               torch.bfloat16 else b), key
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert type(a) is type(b), key


def test_checkpoint_round_trip_bitwise(tmp_path):
    saved = _state(1)
    path = tckpt.save(tmp_path, 3, saved, metadata={"step": 3, "x": [1]})
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["leaves"]["params__weight"] == {"shape": [3, 5],
                                                    "dtype": "bfloat16"}
    assert manifest["leaves"]["opt__v__w__q"]["dtype"] == "int8"
    assert "comp__q__1" not in manifest["leaves"]   # None: no leaf
    template = _state(2)
    module = template["params"]
    restored, meta = tckpt.restore(tmp_path, template)
    assert meta == {"step": 3, "x": [1]}
    assert restored["params"] is module            # loaded in place
    assert restored["comp"]["q"][1] is None
    assert isinstance(restored["opt"], type(saved["opt"]))
    _assert_bitwise(restored, saved)


def test_checkpoint_retention_and_latest_step(tmp_path):
    state = {"w": torch.arange(12.0).reshape(3, 4)}
    (tmp_path / "step_9.tmp").mkdir()      # never committed
    assert tckpt.latest_step(tmp_path) is None
    for step in (1, 2, 3, 4):
        tckpt.save(tmp_path, step, state, metadata={"step": step}, keep=2)
    assert tckpt.all_steps(tmp_path) == [3, 4]
    assert tckpt.latest_step(tmp_path) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_3", "step_4", "step_9.tmp"]
    _, meta = tckpt.restore(tmp_path, state, step=3)
    assert meta == {"step": 3}
    with pytest.raises(FileNotFoundError):
        tckpt.restore(tmp_path / "none", state)


def test_checkpoint_checks_every_leaf_before_touching_state(tmp_path):
    saved = _state(1)
    tckpt.save(tmp_path, 1, saved)
    template = _state(2)
    before = template["params"].weight.clone()
    template["comp"]["n"] = torch.arange(7)           # the last leaf
    with pytest.raises(ValueError, match="comp__n"):
        tckpt.restore(tmp_path, template)
    assert torch.equal(template["params"].weight, before)
    template = _state(2)
    template["extra"] = torch.zeros(2)
    with pytest.raises(KeyError, match="extra"):
        tckpt.restore(tmp_path, template)
    assert torch.equal(template["params"].weight, before)


def test_checkpoint_reads_and_writes_the_references_layout(tmp_path):
    """The reference's checkpoint restores into the port's template, and
    the port's into the reference's, bitwise (dtypes numpy has)."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    m = rng.standard_normal((3, 4)).astype(np.float32)
    jckpt.save(tmp_path / "ref", 2, {"w": jnp.asarray(w), "opt": {
        "m": jnp.asarray(m), "count": jnp.int32(5)}}, metadata={"step": 2})
    template = {"w": torch.zeros(3, 4), "opt": {
        "m": torch.zeros(3, 4), "count": torch.tensor(0, dtype=torch.int32)}}
    got, meta = tckpt.restore(tmp_path / "ref", template)
    assert meta == {"step": 2}
    np.testing.assert_array_equal(got["w"].numpy(), w)
    np.testing.assert_array_equal(got["opt"]["m"].numpy(), m)
    assert int(got["opt"]["count"]) == 5
    tckpt.save(tmp_path / "port", 4, {"w": torch.tensor(w), "opt": {
        "m": torch.tensor(m), "count": torch.tensor(5, dtype=torch.int32)}})
    back, _ = jckpt.restore(tmp_path / "port", {
        "w": jnp.zeros((3, 4)), "opt": {"m": jnp.zeros((3, 4)),
                                        "count": jnp.int32(0)}})
    np.testing.assert_array_equal(np.asarray(back["w"]), w)
    np.testing.assert_array_equal(np.asarray(back["opt"]["m"]), m)
    assert int(back["opt"]["count"]) == 5


# -- shapes and accounting ------------------------------------------------------

def test_shape_cells_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCH_IDS))
def test_applicable_and_input_specs_match_reference(arch):
    cfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for name in jshapes.SHAPES:
        assert tshapes.applicable(tcfg, tshapes.SHAPES[name]) == \
            jshapes.applicable(cfg, jshapes.SHAPES[name])
    # train and prefill at a small batch (the specs allocate nothing
    # either way); decode at a reduced width, whose state is built
    rcfg, trcfg = (jconfigs.reduced_config(arch),
                   tconfigs.reduced_config(arch))
    for kind, c, tc in (("train", cfg, tcfg), ("prefill", cfg, tcfg),
                        ("decode", rcfg, trcfg)):
        seq = c.n_patches + 64
        want = jshapes.input_specs(c, jshapes.ShapeCell("x", seq, 2, kind))
        got = tshapes.input_specs(tc, tshapes.ShapeCell("x", seq, 2, kind))
        assert set(got) == set(want)
        if kind != "decode":
            for k in want:
                assert got[k][0] == want[k].shape, (kind, k)
                assert str(got[k][1]).split(".")[-1] == str(want[k].dtype)
            continue
        assert got["token"] == ((2,), torch.int32)
        assert got["state"].pos == seq     # the reference's pos: cache_len
        _decode_specs_match(got["state"], want["state"], trcfg)


def _decode_specs_match(got, want, cfg):
    """The port's per-layer head-major caches against the reference's
    group-stacked (n_groups, B, S, KV, hd) ones."""
    per = ttfm.period(cfg)
    for i, cache in enumerate(got.caches):
        ref = want.caches[f"l{i % per}"]
        for (shape, dtype), w in zip(cache, ref):
            w_shape = w.shape[1:]
            if len(shape) == 4:           # (B, KV, S, hd) vs (B, S, KV, hd)
                w_shape = (w_shape[0], w_shape[2], w_shape[1], w_shape[3])
            assert shape == w_shape and str(dtype).split(".")[-1] == \
                str(w.dtype)
        assert len(cache) == len(ref)
    assert (got.enc_kvs is None) == (want.enc_kvs is None)


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCH_IDS))
def test_param_counts_and_flops_match_reference(arch):
    cfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert taccounting.param_counts(tcfg) == jaccounting.param_counts(cfg)
    for name in jshapes.SHAPES:
        assert taccounting.model_flops(tcfg, tshapes.SHAPES[name]) == \
            jaccounting.model_flops(cfg, jshapes.SHAPES[name])


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCH_IDS))
def test_param_counts_equal_the_models_weights(arch):
    cfg = dataclasses.replace(tconfigs.reduced_config(arch), tp=1)
    model = ttfm.Transformer(cfg, "meta")
    counted = sum(p.numel() for name, p in model.named_parameters()
                  if "norm" not in name and name != "embed.pos")
    assert taccounting.param_counts(cfg)["total"] == counted


def test_olmo_1b_parameter_count():
    cfg = dataclasses.replace(tconfigs.get_config("olmo-1b"), tp=1)
    model = ttfm.Transformer(cfg, "meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == taccounting.param_counts(cfg)["total"] == 1_279_787_008


# -- watchdog and elastic resume ------------------------------------------------

WATCHDOGS = {"ref": jwatchdog, "port": twatchdog}


@pytest.fixture(params=sorted(WATCHDOGS))
def wd_mod(request, monkeypatch):
    """A package's watchdog module, its clock a fake one that ``advance``
    moves."""
    mod = WATCHDOGS[request.param]
    now = [100.0]
    monkeypatch.setattr(mod, "time",
                        types.SimpleNamespace(monotonic=lambda: now[0]))
    return types.SimpleNamespace(
        Watchdog=mod.Watchdog, STALL_EXIT_CODE=mod.STALL_EXIT_CODE,
        advance=lambda s: now.__setitem__(0, now[0] + s))


def test_watchdog_straggler_accounting(wd_mod):
    wd = wd_mod.Watchdog(stall_factor=1e6, straggler_factor=1.5)
    for i in range(5):
        wd.start_step(i)
        wd_mod.advance(0.01)
        wd.end_step()
    wd.start_step(5)
    wd_mod.advance(0.08)
    assert wd.end_step() == pytest.approx(0.08)
    assert len(wd.stragglers) == 1 and wd.stragglers[0].step == 5
    summary = wd.summary()
    assert summary["n_stragglers"] == 1
    assert summary["ewma_step_s"] == pytest.approx(0.9 * 0.01 + 0.1 * 0.08)
    assert not wd.stalled


def test_watchdog_stall_fires(wd_mod):
    import threading
    fired = threading.Event()
    wd = wd_mod.Watchdog(stall_factor=1.0, floor_s=0.02,
                         on_stall=fired.set)
    wd.start_step(0)
    assert fired.wait(10.0) and wd.stalled
    wd.end_step()
    assert wd_mod.STALL_EXIT_CODE == 42


def test_resume_or_init(tmp_path):
    calls = []

    def init():
        calls.append(1)
        return {"w": torch.zeros(3)}

    state, meta, resumed = telastic.resume_or_init(tmp_path, None, init)
    assert not resumed and meta == {} and calls == [1]
    tckpt.save(tmp_path, 5, {"w": torch.arange(3.0)}, metadata={"step": 5})
    state, meta, resumed = telastic.resume_or_init(
        tmp_path, {"w": torch.zeros(3)}, init)
    assert resumed and meta == {"step": 5} and calls == [1]
    assert torch.equal(state["w"], torch.arange(3.0))


def test_pick_mesh_waits_for_the_multi_device_slice():
    # the mesh is picked (tests/test_torch_mesh.py holds its shapes to the
    # reference's); a step on it waits for the LM half of the multi-device
    # work
    mesh = telastic.pick_mesh(2, devices=["cpu"] * 8, global_batch=4)
    assert dict(mesh.shape) == {"data": 4, "model": 2}
    cfg = tconfigs.reduced_config("olmo-1b")
    shape = tshapes.ShapeCell("x", 8, 4, "train")
    with pytest.raises(NotImplementedError, match="queue 1, item 4"):
        tsteps.build_step("train", cfg, shape, device="cpu", mesh=mesh)


# -- step builders --------------------------------------------------------------

def test_steps_refuse_a_mesh():
    cfg = tconfigs.reduced_config("olmo-1b")
    shape = tshapes.ShapeCell("x", 8, 2, "train")
    for kind in ("train", "prefill", "decode"):
        with pytest.raises(NotImplementedError, match="queue 1, item 4"):
            tsteps.build_step(kind, cfg, shape, device="cpu",
                              mesh=object())


def test_prefill_and_serve_steps_are_the_served_path():
    cfg = tconfigs.reduced_config("olmo-1b")
    model = ttfm.init_model(cfg, seed=0, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    prefill, specs = tsteps.build_step(
        "prefill", cfg, tshapes.ShapeCell("x", 8, 2, "prefill"),
        device="cpu")
    assert specs == {"tokens": ((2, 8), torch.int32)}
    logits, state = prefill(model, {"tokens": tokens})
    want, wstate = ttfm.prefill(model, {"tokens": torch.as_tensor(tokens)},
                                cfg)
    assert torch.equal(logits, want) and state.pos == wstate.pos == 8
    serve, specs = tsteps.build_step(
        "decode", cfg, tshapes.ShapeCell("x", 8, 2, "decode"), device="cpu")
    assert specs["token"] == ((2,), torch.int32)
    tok = logits.argmax(-1)
    nxt, step_logits, _ = serve(model, state, tok.numpy())
    want, _ = ttfm.decode_step(model, wstate, tok, cfg)
    assert torch.equal(step_logits, want)
    assert torch.equal(nxt, want.argmax(-1))


def test_train_step_updates_the_model_in_place():
    from repro_torch.optim import adamw
    cfg = tconfigs.reduced_config("olmo-1b")
    step, specs = tsteps.build_train_step(
        cfg, tshapes.ShapeCell("x", 16, 2, "train"), device="cpu")
    assert specs == {"tokens": ((2, 16), torch.int32)}
    model = ttfm.init_model(cfg, seed=0, device="cpu", train=True)
    before = {k: p.clone() for k, p in model.named_parameters()}
    params = dict(model.named_parameters())
    state = tsteps.TrainState(model, adamw.init(params, adamw.AdamWConfig()),
                              torch.tensor(0, dtype=torch.int32))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    new, metrics = step(state, {"tokens": tokens})
    assert new.params is model and int(new.step) == 1
    assert int(new.opt.count) == 1
    assert set(metrics) == {"loss", "ce", "aux", "grad_norm", "lr"}
    assert all(not t.requires_grad for t in metrics.values())
    assert all(not torch.equal(p, before[k])
               for k, p in model.named_parameters())
    assert all(p.grad is None for p in model.parameters())


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCH_IDS))
def test_compression_sees_the_references_layout(arch):
    """``stack_layers`` lays the port's parameters out as the reference's
    tree (same names, shapes and dtypes), ``unstack_layers`` inverts it
    bitwise, and ``init_compression`` compresses the reference's leaves."""
    from repro.models import transformer as jtfm
    from repro.optim import compression as jcomp
    from repro_torch.optim import compression as tcomp
    cfg = tconfigs.reduced_config(arch)
    want = {".".join(part[2:-2] for part in path): leaf
            for path, leaf in jcomp._flatten(jtfm.param_values(
                jtfm.abstract_init(jconfigs.reduced_config(arch)))).items()}
    model = ttfm.init_model(cfg, seed=0, device="cpu")
    params = dict(model.named_parameters())
    stacked = tsteps.stack_layers(params, cfg)
    assert {k: (tuple(t.shape), str(t.dtype).split(".")[-1])
            for k, t in stacked.items()} == {
        k: (tuple(a.shape), str(a.dtype)) for k, a in want.items()}
    back = tsteps.unstack_layers(stacked, params, cfg)
    assert list(back) == list(params)
    assert all(torch.equal(back[k], p) for k, p in params.items())
    ccfg = tcomp.CompressionConfig(min_size=1024)
    state = tsteps.init_compression(params, cfg, ccfg)
    assert {k for k, q in state.q.items() if q is not None} == {
        k for k, a in want.items() if a.ndim >= 2 and a.size >= 1024}


# -- the CLI --------------------------------------------------------------------

def test_cli_loss_falls(capsys):
    losses = train.main(["--arch", "olmo-1b", "--reduced", "--steps", "25",
                         "--global-batch", "8", "--seq-len", "64", "--lr",
                         "1e-2", "--log-every", "100"], device="cpu")
    assert len(losses) == 25 and np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"final_loss", "first_loss", "watchdog"}
    assert line["final_loss"] == losses[-1]
    assert line["first_loss"] == losses[0]


@pytest.mark.parametrize("extra", [[], ["--moments", "int8",
                                        "--compress-grads", "4"]],
                         ids=["fp32_moments", "int8_compressed"])
def test_cli_preempt_and_resume_is_bitwise(tmp_path, extra):
    base = REDUCED + ["--steps", "6"] + extra
    straight = train.main(base, device="cpu")
    ck = str(tmp_path / "ck")
    first = train.main(base + ["--ckpt-dir", ck, "--ckpt-every", "100",
                               "--preempt-at", "3"], device="cpu")
    assert len(first) == 3 and tckpt.all_steps(ck) == [3]
    rest = train.main(base + ["--ckpt-dir", ck, "--ckpt-every", "100"],
                      device="cpu")
    assert first + rest == straight
    assert tckpt.all_steps(ck) == [3, 6]


def test_cli_int8_moments_training():
    losses = train.main(REDUCED + ["--steps", "15", "--moments", "int8"],
                        device="cpu")
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b",
                                  "arctic-480b", "whisper-small",
                                  "llava-next-34b"])
def test_cli_trains_every_family(arch):
    losses = train.main(["--arch", arch, "--reduced", "--steps", "3",
                         "--global-batch", "2", "--seq-len", "16",
                         "--log-every", "100"], device="cpu")
    assert len(losses) == 3 and np.isfinite(losses).all()


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(REDUCED + ["--steps", "1"])


def test_cli_model_parallel_waits_for_the_multi_device_slice():
    with pytest.raises(NotImplementedError, match="queue 1, item 4"):
        train.main(REDUCED + ["--model-parallel", "2"], device="cpu")


def test_cli_stall_checkpoints_and_exits(tmp_path, monkeypatch):
    class Stalled(twatchdog.Watchdog):
        def end_step(self):
            self.stalled = True
            return super().end_step()

    monkeypatch.setattr(train, "Watchdog", Stalled)
    with pytest.raises(SystemExit) as exit_:
        train.main(REDUCED + ["--steps", "4", "--ckpt-dir",
                              str(tmp_path)], device="cpu")
    assert exit_.value.code == train.STALL_EXIT_CODE
    assert tckpt.all_steps(tmp_path) == [0]


def test_cli_sigterm_checkpoints_after_the_step(tmp_path, monkeypatch):
    batch_at = TokenPipeline.batch_at

    def batch_at_then_term(self, step):
        if step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return batch_at(self, step)

    monkeypatch.setattr(TokenPipeline, "batch_at", batch_at_then_term)
    handler = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as exit_:
        train.main(REDUCED + ["--steps", "4", "--ckpt-dir",
                              str(tmp_path)], device="cpu")
    assert exit_.value.code == train.STALL_EXIT_CODE
    assert tckpt.all_steps(tmp_path) == [2]
    _, meta = tckpt.restore(tmp_path, {})
    assert meta["data"] == {"step": 0} and meta["step"] == 2
    assert signal.getsignal(signal.SIGTERM) is handler
