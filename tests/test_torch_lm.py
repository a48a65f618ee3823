"""The port's LM stack (``repro_torch.models``, ``repro_torch.configs``)
against the reference's, on the CPU: the dense family and, since the
mamba and MoE modules, the moe, ssm and hybrid ones, and since the
encoder-decoder slice encdec and vlm.

The reference's parameters (``tfm.param_values(tfm.init_model(...))``,
with the biases and norm scales redrawn so that they are not the trivial
zeros and ones) are carried across with ``convert.lm_params_to_port``;
the same seeded prompt goes through the reference's ``tfm.prefill`` and
``tfm.decode_step`` under ``REPLICATED`` rules and through the port's.
The prefill's last logits, its KV cache (mapped to the reference's
layout by ``convert.decode_state_to_reference``) and four teacher-forced
decode steps' logits are held to relative Frobenius ``TOL``: both run in
fp32 (``reduced_config`` sets it) and sum in other orders (XLA against
torch's CPU kernels; the port's flash op against the reference's dense or
chunked softmax), and the 2-layer models measured 1e-6 of logits of
magnitude 3 (max abs 3e-6).

Cases: olmo-1b (nonparametric norm, MHA), granite-8b with 2 KV heads
(GQA, G = 2), granite-34b (MQA), qwen1.5-32b (``qkv_bias``), the
reference's chunked branch (``attn_chunk`` 8, S = 2 chunks), padded heads
(``tp`` 4: olmo with 6 heads and a padded vocabulary, granite GQA with 6
query heads over 2 KV heads, the padded heads clamped to the last group)
and the ring-buffer wrap (decode past the cache's capacity); then
``FAMILIES``: falcon-mamba (mamba layers, no FFN), arctic and llama4
(MoE with a dense residual or a shared expert), the 2-layer jamba
stand-in and jamba's reduced 8-layer period, whisper-small (encoder and
cross attention over 16 seeded N(0, 1) frames, learned positions; also
with ``qkv_bias`` and with 2 KV heads) and llava-next-34b (8 seeded patch
embeddings before the prompt, GQA over 1 KV head).  Their caches are KV
caches and Mamba caches (conv window, final scan state), held to ``TOL``
as pairs; the MoE's summed ``aux`` of ``forward`` to ``TOL`` relative.
The 2-layer models measured 1e-6, the 8-layer period 2.3e-6.
``tests/test_torch_encdec.py`` holds the encdec and vlm pieces alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtfm
from repro.parallel.sharding import REPLICATED
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.models.config import ModelConfig

from _torch_parity import lm_extra_inputs, ref_lm_params, rel_frobenius

TOL = 1e-5
PROMPT, CACHE_LEN, STEPS, BATCH = 16, 20, 4, 2

CASES = {
    "olmo_mha": ("olmo-1b", {}),
    "granite8b_gqa": ("granite-8b", {"n_kv_heads": 2}),
    "granite34b_mqa": ("granite-34b", {}),
    "qwen_qkv_bias": ("qwen1.5-32b", {}),
    "olmo_chunked": ("olmo-1b", {"attn_chunk": 8}),
    "olmo_padded_heads": ("olmo-1b", {"n_heads": 6, "n_kv_heads": 6,
                                      "tp": 4, "vocab_size": 250}),
    "granite_padded_gqa": ("granite-8b", {"n_heads": 6, "n_kv_heads": 2,
                                          "tp": 4}),
}

# the moe, ssm and hybrid families: reduced falcon-mamba (2 mamba layers,
# no FFN), arctic (top-2 + dense residual), llama4 (top-1 + shared
# expert), the 2-layer jamba stand-in of tests/test_archs.py (a mamba and
# an attention layer, MoE on the second) and, once, jamba's whole reduced
# 8-layer period (7 mamba + 1 attention, MoE every other layer)
JAMBA_2 = {"n_layers": 2, "attn_every": 2, "moe_every": 2}
FAMILIES = {
    "falcon_mamba": ("falcon-mamba-7b", {}),
    "arctic_moe": ("arctic-480b", {}),
    "llama4_moe": ("llama4-maverick-400b-a17b", {}),
    "jamba_2layer": ("jamba-v0.1-52b", JAMBA_2),
    "jamba_period": ("jamba-v0.1-52b", {}),
    "whisper": ("whisper-small", {}),
    "whisper_qkv_bias": ("whisper-small", {"qkv_bias": True}),
    "whisper_gqa": ("whisper-small", {"n_kv_heads": 2}),
    "llava": ("llava-next-34b", {}),
}
# the cases that run more than the cached prefill-and-decode run
FAMILIES_FAST = sorted(set(FAMILIES) - {"jamba_period"})
ALL_CASES = sorted(CASES) + sorted(FAMILIES)


_ref_params = ref_lm_params


def _ref_caches(state) -> dict:
    """The reference's group-stacked caches as numpy pairs: (k, v) of a
    ``KVCache``, (conv, state) of a ``MambaCache``."""
    return {k: tuple(np.asarray(t) for t in c)
            for k, c in state.caches.items()}


def _inputs(extra: dict, torch_side: bool) -> dict:
    """numpy frames / patches as the reference's or the port's input."""
    return {k: torch.as_tensor(a) if torch_side else jnp.asarray(a)
            for k, a in extra.items()}


def _run(arch, overrides, cache_len=CACHE_LEN, steps=STEPS):
    cfg = jconfigs.reduced_config(arch, **overrides)
    tcfg = tconfigs.reduced_config(arch, **overrides)
    params = _ref_params(cfg)
    model = convert.lm_params_to_port(params, tcfg, device="cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (steps, BATCH)).astype(np.int32)
    extra = lm_extra_inputs(cfg, BATCH, rng)
    n_prefix = extra["patches"].shape[1] if "patches" in extra else 0

    ref, port = {"decode": []}, {"decode": []}
    ref["vocab"] = port["vocab"] = cfg.vocab_size
    ref["n_prefix"] = n_prefix
    logits, state = jtfm.prefill(
        params, {"tokens": jnp.asarray(tokens), **_inputs(extra, False)},
        cfg, REPLICATED, cache_len=cache_len + n_prefix)
    ref["prefill"] = np.asarray(logits)
    ref["cache"] = _ref_caches(state)
    tlogits, tstate = ttfm.prefill(
        model, {"tokens": torch.as_tensor(tokens, dtype=torch.int64),
                **_inputs(extra, True)}, tcfg,
        cache_len=cache_len + n_prefix)
    port["prefill"] = tlogits.numpy()
    port["cache"] = convert.decode_state_to_reference(tstate, tcfg)["caches"]
    port["pos"] = tstate.pos
    ref["pos"] = int(state.pos)
    for tok in forced:
        logits, state = jtfm.decode_step(params, state, jnp.asarray(tok),
                                         cfg, REPLICATED)
        ref["decode"].append(np.asarray(logits))
        tlogits, tstate = ttfm.decode_step(
            model, tstate, torch.as_tensor(tok, dtype=torch.int64), tcfg)
        port["decode"].append(tlogits.numpy())
    ref["final_cache"] = _ref_caches(state)
    port["final_cache"] = convert.decode_state_to_reference(
        tstate, tcfg)["caches"]
    return ref, port


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _run(*{**CASES, **FAMILIES}[case])
        return cache[case]
    return get


# -- configs ------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_registry_config_equals_reference(arch):
    want, got = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for derived in ("padded_heads", "padded_vocab", "group_size", "d_inner",
                    "dt_rank", "is_attention_free"):
        assert getattr(got, derived) == getattr(want, derived), derived
    assert got.layer_kinds() == want.layer_kinds()
    assert got.ffn_kinds() == want.ffn_kinds()
    assert dataclasses.asdict(tconfigs.reduced_config(arch)) == \
        dataclasses.asdict(jconfigs.reduced_config(arch))
    assert got.torch_dtype() == {"bfloat16": torch.bfloat16,
                                 "float32": torch.float32}[want.dtype]


def test_registry_ids_and_defaults():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    from repro.models.config import ModelConfig as JModelConfig
    assert dataclasses.asdict(ModelConfig()) == \
        dataclasses.asdict(JModelConfig())
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")
    with pytest.raises(ValueError):  # n_heads % n_kv_heads
        ModelConfig(n_heads=4, n_kv_heads=3, tp=1).validate()


# -- prefill and decode against the reference ----------------------------------

@pytest.mark.parametrize("case", ALL_CASES)
def test_prefill_last_logits(runs, case):
    ref, port = runs(case)
    assert port["prefill"].shape == ref["prefill"].shape
    n = ref["vocab"]  # the true vocabulary: -1e30 would swamp the norm
    assert rel_frobenius(port["prefill"][:, :n], ref["prefill"][:, :n]) <= TOL
    # the padded vocabulary is masked as the reference masks it
    np.testing.assert_array_equal(port["prefill"] <= -1e29,
                                  ref["prefill"] <= -1e29)


@pytest.mark.parametrize("case", ALL_CASES)
def test_prefill_kv_cache(runs, case):
    ref, port = runs(case)
    prompt = PROMPT + ref["n_prefix"]  # a vlm's patches are in the cache
    assert port["pos"] == ref["pos"] == prompt
    assert sorted(port["cache"]) == sorted(ref["cache"])
    for name, (k, v) in ref["cache"].items():
        pk, pv = port["cache"][name]
        assert pk.shape == k.shape and pv.shape == v.shape
        assert rel_frobenius(pk, k) <= TOL and rel_frobenius(pv, v) <= TOL
        # capacity past the prompt is zero in both
        assert not pk[:, :, prompt:].any() and not k[:, :, prompt:].any()


@pytest.mark.parametrize("case", ALL_CASES)
def test_teacher_forced_decode_logits(runs, case):
    ref, port = runs(case)
    n = ref["vocab"]
    for step, (got, want) in enumerate(zip(port["decode"], ref["decode"])):
        assert rel_frobenius(got[:, :n], want[:, :n]) <= TOL, step
        np.testing.assert_array_equal(got[:, n:], want[:, n:])
    for name, (k, v) in ref["final_cache"].items():
        pk, pv = port["final_cache"][name]
        assert rel_frobenius(pk, k) <= TOL and rel_frobenius(pv, v) <= TOL


@pytest.mark.parametrize("arch,overrides", [("olmo-1b", {}),
                                            ("granite-8b",
                                             {"n_kv_heads": 2})])
def test_ring_buffer_wrap(arch, overrides):
    """cache_len = prompt: every decode step is past the capacity, so the
    reference attends all S slots plus the new token before it overwrites
    slot pos % S; the port must give the same logits and cache."""
    ref, port = _run(arch, overrides, cache_len=PROMPT, steps=3)
    for got, want in zip(port["decode"], ref["decode"]):
        assert rel_frobenius(got, want) <= TOL
    for name, (k, v) in ref["final_cache"].items():
        pk, pv = port["final_cache"][name]
        assert pk.shape[2] == PROMPT
        assert rel_frobenius(pk, k) <= TOL and rel_frobenius(pv, v) <= TOL


def test_forward_train_full_logits():
    cfg = jconfigs.reduced_config("qwen1.5-32b")
    tcfg = tconfigs.reduced_config("qwen1.5-32b")
    params = _ref_params(cfg, seed=3)
    model = convert.lm_params_to_port(params, tcfg, device="cpu")
    tokens = np.random.default_rng(4).integers(0, 256, (2, 12)).astype(
        np.int32)
    want, _, _, _, _ = jtfm.forward(params, {"tokens": jnp.asarray(tokens)},
                                    cfg, REPLICATED, "train")
    got, aux, caches, enc, npfx = ttfm.forward(
        model, {"tokens": torch.as_tensor(tokens, dtype=torch.int64)}, tcfg,
        "train")
    assert caches is None and enc is None and npfx == 0 and float(aux) == 0
    assert rel_frobenius(got.numpy(), np.asarray(want)) <= TOL
    # prefill's last row is the forward's, computed alone
    last, _ = ttfm.prefill(model, {"tokens": torch.as_tensor(
        tokens, dtype=torch.int64)}, tcfg)
    assert rel_frobenius(last.numpy(), got[:, -1].numpy()) <= 1e-6


# -- conversions and the port's own seams --------------------------------------

def test_decode_state_to_reference_layout():
    """Layer i's head-major (B, KV, S, hd) cache lands at [i] of the
    reference's (layers, B, S, KV, hd) stack, bitwise."""
    cfg = tconfigs.reduced_config("granite-8b", n_kv_heads=2)
    g = torch.Generator().manual_seed(0)
    caches = [tattn.KVCache(*(torch.randn(2, 2, 7, 16, generator=g)
                              for _ in range(2)))
              for _ in range(cfg.n_layers)]
    state = ttfm.DecodeState(caches=caches, enc_kvs=None, pos=5)
    back = convert.decode_state_to_reference(state, cfg)
    assert back["pos"] == 5 and sorted(back["caches"]) == ["l0"]
    k, v = back["caches"]["l0"]
    assert k.shape == v.shape == (cfg.n_layers, 2, 7, 2, 16)
    for i, c in enumerate(caches):
        np.testing.assert_array_equal(k[i], c.k.transpose(1, 2).numpy())
        np.testing.assert_array_equal(v[i], c.v.transpose(1, 2).numpy())


def test_lm_params_round_trip_is_exact():
    cfg = jconfigs.reduced_config("qwen1.5-32b")
    tcfg = tconfigs.reduced_config("qwen1.5-32b")
    params = _ref_params(cfg)
    model = convert.lm_params_to_port(params, tcfg, device="cpu")
    state = convert.lm_state_dict(params, tcfg)
    assert sorted(state) == sorted(model.state_dict())
    for key, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), state[key])
    assert model.layers[1].mixer.wq.shape == params["blocks"]["l0"][
        "mixer"]["wq"].shape[1:]


def test_make_decode_state():
    cfg = tconfigs.reduced_config("granite-34b")
    st = ttfm.make_decode_state(cfg, batch=3, cache_len=9, device="cpu")
    ref = jtfm.make_decode_state(jconfigs.reduced_config("granite-34b"), 3, 9)
    assert st.pos == int(ref.pos) == 9
    assert len(st.caches) == cfg.n_layers
    k_ref = ref.caches["l0"].k  # (layers, B, S, KV, hd)
    assert st.caches[0].k.shape == (k_ref.shape[1], k_ref.shape[3],
                                    k_ref.shape[2], k_ref.shape[4])
    assert st.caches[0].k.dtype == torch.float32


def test_ring_attention_raises():
    """Ring attention builds and runs (it raised until the multi-device
    slice): without a mesh a ring config takes the reference's other
    branch, attention over unpadded heads, and matches the reference's
    ``REPLICATED`` forward; its decode state builds.  The 4-way ring is
    held in ``tests/test_torch_dist_lm.py``."""
    cfg = tconfigs.reduced_config("olmo-1b", attn_impl="ring", tp=4,
                                  n_heads=6, n_kv_heads=2)
    assert cfg.padded_heads == 6
    jcfg = jconfigs.reduced_config("olmo-1b", attn_impl="ring", tp=4,
                                   n_heads=6, n_kv_heads=2)
    params = ref_lm_params(jcfg)
    model = convert.lm_params_to_port(params, cfg, device="cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 8))
    got = ttfm.forward(model, {"tokens": torch.as_tensor(tokens)}, cfg)[0]
    want = jtfm.forward(params, {"tokens": jnp.asarray(tokens)}, jcfg,
                        REPLICATED)[0]
    assert rel_frobenius(got, np.asarray(want)) < TOL
    state = ttfm.make_decode_state(cfg, 1, 4, device="cpu")
    assert state.caches[0].k.shape == (1, cfg.n_kv_heads, 4, cfg.head_dim)


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        ttfm.init_model(tconfigs.reduced_config("olmo-1b"))


def test_mha_decode_attends_the_cache_in_place(monkeypatch):
    """An MHA decode step hands the flash op the cache itself (no copy),
    one query row at q_offset = pos; a GQA step G rows over keys 0..pos."""
    seen = []
    real = tattn.ops.flash_attention

    def spy(q, k, v, causal=True, scale=None, q_offset=0, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), causal, q_offset,
                     k.data_ptr()))
        return real(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                    **kw)

    for arch, ov, rows in (("olmo-1b", {}, 1),
                           ("granite-8b", {"n_kv_heads": 2}, 2)):
        cfg = tconfigs.reduced_config(arch, **ov)
        model = ttfm.init_model(cfg, device="cpu")
        tokens = torch.arange(8).reshape(1, 8)
        _, st = ttfm.prefill(model, {"tokens": tokens}, cfg, cache_len=12)
        monkeypatch.setattr(tattn.ops, "flash_attention", spy)
        seen.clear()
        ttfm.decode_step(model, st, torch.tensor([3]), cfg)
        monkeypatch.undo()
        assert len(seen) == cfg.n_layers
        q_shape, k_shape, causal, q_offset, ptr = seen[0]
        kv = cfg.n_kv_heads
        assert q_shape == (kv, rows, cfg.head_dim)
        if rows == 1:
            assert (k_shape, causal, q_offset) == ((kv, 12, 16), True, 8)
            assert ptr == st.caches[0].k.data_ptr()
        else:
            assert (k_shape, causal) == ((kv, 9, 16), False)


@pytest.mark.parametrize("case", sorted(CASES) + ["olmo_wrap", "granite_wrap"])
def test_flash_operands_are_what_the_kernels_take(monkeypatch, case):
    """Every call of the flash op in prefill and decode hands it q (BH, Sq,
    D) and k, v (BH, Skv, D), contiguous and of one dtype: the CUDA
    wrapper raises on anything else, and the CPU's plain version would
    not notice."""
    _flash_operands(monkeypatch, case, 2)


@pytest.mark.parametrize("case", sorted(CASES) + ["olmo_wrap", "granite_wrap"])
def test_flash_operands_at_batch_one(monkeypatch, case):
    """The same at batch 1, where reshaping the (B, H, S, hd) query view to
    (B * H, S, hd) keeps its strides instead of copying."""
    _flash_operands(monkeypatch, case, 1)


def _flash_operands(monkeypatch, case, batch):
    arch, ov = CASES.get(case, ("olmo-1b" if case == "olmo_wrap" else
                                "granite-8b", {}))
    cfg = tconfigs.reduced_config(arch, **ov)
    model = ttfm.init_model(cfg, device="cpu")
    real = tattn.ops.flash_attention
    calls = []

    def spy(q, k, v, causal=True, scale=None, q_offset=0, **kw):
        calls.append(q.shape[1])
        for t in (q, k, v):
            assert t.ndim == 3 and t.is_contiguous() and t.dtype == q.dtype
        assert k.shape == v.shape and k.shape[0] == q.shape[0]
        return real(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                    **kw)

    monkeypatch.setattr(tattn.ops, "flash_attention", spy)
    tokens = torch.arange(batch * PROMPT).reshape(batch, PROMPT) % \
        cfg.vocab_size
    wrap = case.endswith("_wrap")
    _, st = ttfm.prefill(model, {"tokens": tokens}, cfg,
                         cache_len=PROMPT if wrap else CACHE_LEN)
    for i in range(3):
        _, st = ttfm.decode_step(model, st, tokens[:, i], cfg)
    assert len(calls) == 4 * cfg.n_layers
    assert calls[0] == PROMPT and set(calls[cfg.n_layers:]) == {
        cfg.group_size}


def test_lm_params_to_port_takes_bfloat16_arrays():
    """The reference's default dtype is bf16 (ml_dtypes arrays in numpy):
    carried bit for bit into bf16 tensors; its fp32 norm scales stay fp32."""
    cfg = jconfigs.reduced_config("granite-8b", dtype="bfloat16")
    params = jax.tree.map(np.asarray, jtfm.param_values(
        jtfm.init_model(jax.random.PRNGKey(5), cfg)))
    model = convert.lm_params_to_port(
        params, tconfigs.reduced_config("granite-8b", dtype="bfloat16"),
        device="cpu")
    wq = params["blocks"]["l0"]["mixer"]["wq"][1]
    got = model.layers[1].mixer.wq
    assert got.dtype == torch.bfloat16 and wq.dtype.name == "bfloat16"
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  wq.view(np.int16))
    assert model.layers[0].norm1.scale.dtype == torch.float32


# -- the moe, ssm and hybrid families against the reference --------------------

def _family_models(case, seed: int = 3):
    arch, ov = FAMILIES[case]
    cfg = jconfigs.reduced_config(arch, **ov)
    tcfg = tconfigs.reduced_config(arch, **ov)
    params = _ref_params(cfg, seed=seed)
    return cfg, tcfg, params, convert.lm_params_to_port(params, tcfg,
                                                        device="cpu")


@pytest.mark.parametrize("case", FAMILIES_FAST)
def test_family_forward_logits_and_aux(case):
    """``forward`` in train mode: the full logits and the MoE layers'
    summed load-balance aux (0 without experts) equal the reference's."""
    cfg, tcfg, params, model = _family_models(case)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 256, (2, 12)).astype(np.int32)
    extra = lm_extra_inputs(cfg, 2, rng)
    want, aux, _, _, n_prefix = jtfm.forward(
        params, {"tokens": jnp.asarray(tokens), **_inputs(extra, False)},
        cfg, REPLICATED, "train")
    got, taux, caches, enc, npfx = ttfm.forward(
        model, {"tokens": torch.as_tensor(tokens, dtype=torch.int64),
                **_inputs(extra, True)}, tcfg, "train")
    assert caches is None and enc is None and npfx == n_prefix
    assert got.shape == (2, 12 + npfx, tcfg.padded_vocab)
    assert taux.dtype == torch.float32 and taux.shape == ()
    assert rel_frobenius(got.numpy(), np.asarray(want)) <= TOL
    if tcfg.n_experts:
        assert abs(float(taux) - float(aux)) <= TOL * abs(float(aux))
        assert float(taux) > 0
    else:
        assert float(taux) == float(aux) == 0.0


# the reference adds the cross attention's bq in decode only, so there a
# decode step is not the forward's last row (tests/test_torch_encdec.py
# holds both packages to that)
@pytest.mark.parametrize("case", sorted(set(FAMILIES_FAST)
                                        - {"whisper_qkv_bias"}))
def test_family_prefill_then_decode_matches_forward(case):
    """The reference's ``_decode_smoke`` on the port alone: 8 tokens
    prefilled and the ninth decoded give the 9-token forward's last
    logits (its tolerance: the MoE's capacity differs between the two,
    and binds in neither here)."""
    _, tcfg, _, model = _family_models(case, seed=1)
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, tcfg.vocab_size, (2, 9)),
                             dtype=torch.int64)
    extra = _inputs(lm_extra_inputs(tcfg, 2, rng), True)
    _, state = ttfm.prefill(model, {"tokens": tokens[:, :8], **extra}, tcfg,
                            cache_len=12 + tcfg.n_patches)
    logits, _ = ttfm.decode_step(model, state, tokens[:, 8], tcfg)
    full = ttfm.forward(model, {"tokens": tokens, **extra}, tcfg,
                        "train")[0]
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(),
                               atol=5e-5, rtol=1e-3)


@pytest.mark.parametrize("case", FAMILIES_FAST)
def test_family_params_round_trip(case):
    """The reference's tree onto the port's keys, bitwise, every layer of
    the kind ``layer_kinds()`` / ``ffn_kinds()`` give it."""
    from repro_torch.models import mamba as tmamba
    from repro_torch.models import moe as tmoe
    _, tcfg, params, model = _family_models(case)
    state = convert.lm_state_dict(params, tcfg)
    assert sorted(state) == sorted(model.state_dict())
    for key, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), state[key])
    for layer, mixer, ffn in zip(model.layers, tcfg.layer_kinds(),
                                 tcfg.ffn_kinds()):
        assert isinstance(layer.mixer, tmamba.Mamba) == (mixer == "mamba")
        if tcfg.d_ff:
            assert isinstance(layer.ffn, tmoe.MoE) == (ffn == "moe")
            assert hasattr(layer, "mlp_res") == (
                ffn == "moe" and tcfg.dense_residual)
            assert hasattr(layer, "mlp_shared") == (
                ffn == "moe" and tcfg.shared_expert)
        else:
            assert not hasattr(layer, "ffn")


def test_period_is_the_lcm_of_the_interleaves():
    assert ttfm.period(tconfigs.get_config("jamba-v0.1-52b")) == 8
    assert ttfm.period(tconfigs.reduced_config("jamba-v0.1-52b",
                                               **JAMBA_2)) == 2
    assert ttfm.period(tconfigs.reduced_config(
        "jamba-v0.1-52b", attn_every=4, moe_every=8, n_layers=8)) == 8
    assert ttfm.period(tconfigs.get_config("falcon-mamba-7b")) == 1
    with pytest.raises(ValueError, match="period"):
        ttfm.Transformer(tconfigs.reduced_config(
            "arctic-480b", moe_every=2, n_layers=3), "cpu")


def test_decode_state_to_reference_with_mamba_cache():
    """The jamba stand-in's state: layer 0's ``MambaCache`` (conv, state)
    and layer 1's head-major ``KVCache`` land at group 0 of the
    reference's ``l0`` and ``l1``, bitwise."""
    from repro_torch.models import mamba as tmamba
    cfg = tconfigs.reduced_config("jamba-v0.1-52b", **JAMBA_2)
    g = torch.Generator().manual_seed(0)
    mc = tmamba.MambaCache(
        torch.randn(2, cfg.d_conv - 1, cfg.d_inner, generator=g),
        torch.randn(2, cfg.d_inner, cfg.ssm_state, generator=g))
    kv = tattn.KVCache(*(torch.randn(2, cfg.n_kv_heads, 7, cfg.head_dim,
                                     generator=g) for _ in range(2)))
    back = convert.decode_state_to_reference(
        ttfm.DecodeState(caches=[mc, kv], enc_kvs=None, pos=5), cfg)
    assert back["pos"] == 5 and sorted(back["caches"]) == ["l0", "l1"]
    conv, state = back["caches"]["l0"]
    np.testing.assert_array_equal(conv[0], mc.conv.numpy())
    np.testing.assert_array_equal(state[0], mc.state.numpy())
    k, v = back["caches"]["l1"]
    np.testing.assert_array_equal(k[0], kv.k.transpose(1, 2).numpy())
    np.testing.assert_array_equal(v[0], kv.v.transpose(1, 2).numpy())


@pytest.mark.parametrize("arch,ov", [("falcon-mamba-7b", {}),
                                     ("jamba-v0.1-52b", {}),
                                     ("arctic-480b", {})])
def test_make_decode_state_families(arch, ov):
    """One cache a layer of its mixer's kind, of the reference's shapes
    (KV head-major), zero, pos = cache_len."""
    from repro_torch.models import mamba as tmamba
    cfg = tconfigs.reduced_config(arch, **ov)
    st = ttfm.make_decode_state(cfg, batch=3, cache_len=9, device="cpu")
    ref = jtfm.make_decode_state(jconfigs.reduced_config(arch, **ov), 3, 9)
    assert st.pos == int(ref.pos) == 9 and len(st.caches) == cfg.n_layers
    per = ttfm.period(cfg)
    for i, (c, kind) in enumerate(zip(st.caches, cfg.layer_kinds())):
        want = ref.caches[f"l{i % per}"]
        if kind == "attn":
            assert isinstance(c, tattn.KVCache)
            b, s, kvh, hd = want.k.shape[1:]
            assert c.k.shape == (b, kvh, s, hd)
        else:
            assert isinstance(c, tmamba.MambaCache)
            assert c.conv.shape == want.conv.shape[1:]
            assert c.state.shape == want.state.shape[1:]
            assert c.state.dtype == torch.float32
        assert not any(t.any() for t in c)
