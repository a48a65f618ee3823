"""The port's LM serving CLI (``repro_torch.launch.serve``) on the CPU.

``serve.main([... "--reduced" ...], device="cpu")`` prints the reference
CLI's JSON line (the keys the reference's ``main`` prints) and returns an
int32 (batch, gen_len) array.  Its greedy tokens must equal a loop of the
reference's ``tfm.prefill`` and ``tfm.decode_step`` on the same weights
(the port's seeded model carried into the reference's tree) and the same
prompt (``np.random.default_rng(seed)`` in both): the logits agree to
fp32 rounding (``tests/test_torch_lm.py``), far below the gaps between
the top two logits of these runs, so the argmax is the same token.
The moe family is also served at its published 128 experts, its logits
and drops held to the reference's step by step.
"""
import contextlib
import inspect
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.parallel.sharding import REPLICATED
from repro_torch import configs as tconfigs
from repro_torch.launch import serve
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm

from _torch_parity import lm_params_to_reference, rel_frobenius

TOL = 1e-5
KEYS = ("arch", "prefill_s", "decode_per_token_s", "decode_tokens_per_s",
        "generated_shape", "sample_tokens")


def _serve(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        gen = serve.main(argv, device="cpu")
    return gen, json.loads(out.getvalue().strip().splitlines()[-1])


def _reference_greedy(arch: str, batch: int, prompt: int, gen_len: int,
                      seed: int) -> np.ndarray:
    """The reference's serve loop (prefill, then gen_len decode steps, the
    first of them the warm-up) at temperature 0 on the port's weights."""
    cfg = jconfigs.reduced_config(arch)
    model = ttfm.init_model(tconfigs.reduced_config(arch), seed=seed,
                            device="cpu")
    params = lm_params_to_reference(model, cfg)
    rng = np.random.default_rng(seed)
    tokens = jnp.asarray(rng.integers(0, cfg.vocab_size, (batch, prompt)),
                         jnp.int32)
    inputs = {"tokens": tokens}
    # the reference CLI's stub frontends: zero patches and frames
    if cfg.family == "vlm":
        inputs["patches"] = jnp.zeros((batch, cfg.n_patches, cfg.d_model),
                                      cfg.jdtype())
    if cfg.family == "encdec":
        inputs["frames"] = jnp.zeros((batch, cfg.n_frames, cfg.d_model),
                                     cfg.jdtype())
    cache_len = prompt + gen_len + (cfg.n_patches if cfg.family == "vlm"
                                    else 0)
    logits, state = jtfm.prefill(params, inputs, cfg, REPLICATED,
                                 cache_len=cache_len)
    out = []
    for _ in range(gen_len):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out.append(np.asarray(tok))
        logits, state = jtfm.decode_step(params, state, tok, cfg, REPLICATED)
    return np.stack(out, axis=1)


def test_reference_cli_prints_these_keys():
    src = inspect.getsource(jserve.main)
    for key in KEYS:
        assert f'"{key}"' in src, key


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-34b", "qwen1.5-32b",
                                  "falcon-mamba-7b", "jamba-v0.1-52b",
                                  "arctic-480b",
                                  "llama4-maverick-400b-a17b",
                                  "whisper-small", "llava-next-34b"])
def test_greedy_tokens_equal_the_reference_loop(arch):
    batch, prompt, gen_len, seed = 2, 12, 6, 3
    gen, line = _serve(["--arch", arch, "--reduced", "--batch", str(batch),
                        "--prompt-len", str(prompt), "--gen-len",
                        str(gen_len), "--seed", str(seed)])
    assert tuple(line) == KEYS
    assert line["arch"] == arch
    assert gen.dtype == np.int32 and gen.shape == (batch, gen_len)
    assert line["generated_shape"] == [batch, gen_len]
    assert line["sample_tokens"] == gen[0, :8].tolist()
    assert line["prefill_s"] > 0 and line["decode_tokens_per_s"] > 0
    want = _reference_greedy(arch, batch, prompt, gen_len, seed)
    np.testing.assert_array_equal(gen, want)


def _routed(monkeypatch, module, record):
    """Every ``module._routing`` call records (tokens, idx) through
    ``record``; the reference's idx comes back through a debug callback
    (its layers run under ``lax.scan``)."""
    routing = module._routing

    def call(p, xf, cfg):
        out = routing(p, xf, cfg)
        record(xf.shape[0], out[1])
        return out
    monkeypatch.setattr(module, "_routing", call)


def _drops(routes, cfg) -> list:
    """(tokens, dropped assignments) a routing: an assignment past its
    expert's capacity is dropped (the reference's rule)."""
    out = []
    for t, idx in routes:
        idx = torch.tensor(np.asarray(idx), dtype=torch.int64)
        pos = tmoe.positions(idx.T.reshape(-1), cfg.n_experts)
        out.append((t, int((pos >= tmoe.capacity(t, cfg)).sum())))
    return out


@pytest.mark.parametrize("arch", ["arctic-480b", "llama4-maverick-400b-a17b"])
def test_served_at_128_experts_equals_the_reference(arch, monkeypatch):
    """The published 128 experts at the reduced widths, batch 4: a
    16-token prefill (C = 2 slots an expert for arctic's top 2 of 64
    tokens, 1 for llama4's top 1), then decode steps of 4 tokens (C = 1,
    where capacity binds), the port's greedy tokens fed to both packages.
    Each step's logits within ``TOL`` = 1e-5 relative Frobenius of the
    reference's (fp32: the two sum the matmuls in other orders, about
    1e-7), and every routing drops as many assignments in both."""
    batch, prompt, steps, seed = 4, 16, 8, 3
    over = {"n_experts": 128}
    cfg = jconfigs.reduced_config(arch, **over)
    tcfg = tconfigs.reduced_config(arch, **over)
    model = ttfm.init_model(tcfg, seed=seed, device="cpu")
    params = lm_params_to_reference(model, cfg)
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                  (batch, prompt))
    routes, jroutes = [], []
    _routed(monkeypatch, tmoe, lambda t, idx: routes.append((t, idx)))
    _routed(monkeypatch, jmoe, lambda t, idx: jax.debug.callback(
        lambda i: jroutes.append((t, np.asarray(i))), idx, ordered=True))
    cache_len = prompt + steps
    logits, state = ttfm.prefill(model, {"tokens": torch.as_tensor(tokens)},
                                 tcfg, cache_len=cache_len)
    jlogits, jstate = jtfm.prefill(
        params, {"tokens": jnp.asarray(tokens, jnp.int32)}, cfg, REPLICATED,
        cache_len=cache_len)
    v = cfg.vocab_size
    errs = [rel_frobenius(logits[:, :v].numpy(), np.asarray(jlogits)[:, :v])]
    for _ in range(steps):
        tok = logits.argmax(-1)
        logits, state = ttfm.decode_step(model, state, tok, tcfg)
        jlogits, jstate = jtfm.decode_step(
            params, jstate, jnp.asarray(tok.numpy(), jnp.int32), cfg,
            REPLICATED)
        errs.append(rel_frobenius(logits[:, :v].numpy(),
                                  np.asarray(jlogits)[:, :v]))
    jax.effects_barrier()
    assert max(errs) <= TOL, errs
    n_moe = tcfg.ffn_kinds().count("moe")
    assert len(routes) == len(jroutes) == n_moe * (1 + steps)
    drops, jdrops = _drops(routes, tcfg), _drops(jroutes, tcfg)
    assert drops == jdrops
    assert tmoe.capacity(batch, tcfg) == 1
    assert sum(n for t, n in drops if t == batch) > 0, \
        "no assignment dropped in decode: C = 1 never bound"


def test_temperature_sampling_is_seeded():
    argv = ["--reduced", "--batch", "3", "--prompt-len", "8", "--gen-len",
            "5", "--temperature", "0.8", "--seed", "7"]
    a, _ = _serve(argv)
    b, _ = _serve(argv)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (3, 5) and a.min() >= 0 and a.max() < 256
    greedy, _ = _serve(argv[:-4] + ["--seed", "7"])
    assert not np.array_equal(a, greedy)


def test_sample_is_argmax_at_temperature_zero():
    logits = torch.randn(4, 50, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(serve.sample(logits, None, 0.0).numpy(),
                                  logits.argmax(-1).numpy())


def test_model_parallel_raises():
    """``--model-parallel`` no longer raises: with one process (no
    torchrun environment) the mesh is (1, 1), as the reference's on one
    device, and 2 serves what 1 does.  The 8-process world serves at 4 in
    ``tests/test_torch_dist_train.py``."""
    argv = ["--reduced", "--gen-len", "3", "--prompt-len", "6"]
    one = serve.main(argv + ["--model-parallel", "1"], device="cpu")
    two = serve.main(argv + ["--model-parallel", "2"], device="cpu")
    np.testing.assert_array_equal(one, two)


def test_generate_serves_a_depth_cut_config():
    """``generate`` takes a ``ModelConfig`` (one jamba period cut to its
    2-layer stand-in here) and gives what ``main`` prints for it."""
    import dataclasses
    cfg = dataclasses.replace(tconfigs.reduced_config("jamba-v0.1-52b"),
                              n_layers=2, attn_every=2, moe_every=2)
    gen, line = serve.generate(cfg, batch=2, prompt_len=6, gen_len=3,
                               seed=1, device="cpu")
    assert tuple(line) == KEYS and line["arch"] == "jamba-v0.1-52b"
    assert gen.shape == (2, 3) and line["sample_tokens"] == gen[0].tolist()
    again, _ = serve.generate(cfg, batch=2, prompt_len=6, gen_len=3,
                              seed=1, device="cpu")
    np.testing.assert_array_equal(gen, again)


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--reduced", "--gen-len", "2", "--prompt-len", "4"])
