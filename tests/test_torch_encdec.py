"""The encdec (whisper-small) and vlm (llava-next-34b) pieces of the
port's LM stack against the reference's, on the CPU.

The reference's parameters (redrawn biases and norm parameters,
``ref_lm_params``) are carried across with ``convert.lm_params_to_port``;
seeded N(0, 1) frames (B, n_frames, d) or patches (B, n_patches, d) and a
seeded prompt go through both packages in fp32.  Held to relative
Frobenius ``TOL`` = 1e-5 (the models measured 3e-7 to 1e-6): the prefill's
last logits, the self-attention KV caches, the cross K/V (``enc_kvs``),
eight teacher-forced decode steps' logits, ``forward(mode="train")``'s
full logits (with the vlm's ``n_prefix``) and the encoder's output alone.
Cases: reduced whisper-small (MHA), the same with ``qkv_bias`` (the cross
attention's prefill form adds no bias, its decode form adds ``bq``), with
2 KV heads (GQA, G = 2), with 6 heads padded to 8 (``tp`` 4), and
reduced llava-next-34b (GQA over 1 KV head, 8 patches before the
prompt).  The reduced whisper has 16 frames; the
prompt is 12 tokens, so the cross attention's Sq differs from its Skv.

Also: the non-causal encoder never attends a cache's zero tail; the
sinusoidal table and the learned positions' wrap at 4096; the
``convert`` round trip with the encoder, cross and ``pos`` leaves;
``make_decode_state`` and ``decode_state_to_reference`` for ``enc_kvs``;
the flash op's operands and call counts in both families; ``serve.main``
and ``generate`` for both.
"""
import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.parallel.sharding import REPLICATED
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm

from _torch_parity import lm_extra_inputs, ref_lm_params, rel_frobenius

TOL = 1e-5
BATCH, PROMPT, STEPS = 2, 12, 8
CASES = {
    "whisper": ("whisper-small", {}),
    "whisper_qkv_bias": ("whisper-small", {"qkv_bias": True}),
    "whisper_gqa": ("whisper-small", {"n_kv_heads": 2}),
    # tp 4 pads 6 heads to 8: the encoder and the cross attention take
    # the expanded KV heads and mask the padded ones
    "whisper_padded_heads": ("whisper-small", {"n_heads": 6,
                                               "n_kv_heads": 6, "tp": 4}),
    "llava": ("llava-next-34b", {}),
}
WHISPER = sorted(c for c in CASES if c.startswith("whisper"))


def _inputs(tokens, extra: dict, torch_side: bool) -> dict:
    if torch_side:
        return {"tokens": torch.as_tensor(tokens, dtype=torch.int64),
                **{k: torch.as_tensor(a) for k, a in extra.items()}}
    return {"tokens": jnp.asarray(tokens),
            **{k: jnp.asarray(a) for k, a in extra.items()}}


def _models(case, seed: int = 0):
    arch, ov = CASES[case]
    cfg = jconfigs.reduced_config(arch, **ov)
    tcfg = tconfigs.reduced_config(arch, **ov)
    params = ref_lm_params(cfg, seed)
    return cfg, tcfg, params, convert.lm_params_to_port(params, tcfg,
                                                        device="cpu")


def _run(case):
    """Prefill and ``STEPS`` teacher-forced decode steps through both
    packages: logits, caches, enc_kvs and positions, as numpy."""
    cfg, tcfg, params, model = _models(case)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (STEPS, BATCH)).astype(np.int32)
    extra = lm_extra_inputs(cfg, BATCH, rng)
    cache_len = PROMPT + STEPS + 4 + tcfg.n_patches
    logits, state = jtfm.prefill(params, _inputs(tokens, extra, False), cfg,
                                 REPLICATED, cache_len=cache_len)
    tlogits, tstate = ttfm.prefill(model, _inputs(tokens, extra, True), tcfg,
                                   cache_len=cache_len)

    def ref_state(st):
        return {"caches": {k: tuple(np.asarray(t) for t in c)
                           for k, c in st.caches.items()},
                "enc_kvs": None if st.enc_kvs is None else {
                    k: tuple(np.asarray(t) for t in c)
                    for k, c in st.enc_kvs.items()},
                "pos": int(st.pos)}

    ref = {"prefill": np.asarray(logits), "state": ref_state(state),
           "decode": []}
    port = {"prefill": tlogits.numpy(),
            "state": convert.decode_state_to_reference(tstate, tcfg),
            "decode": []}
    enc_ptrs = ([c.k.data_ptr() for c in tstate.enc_kvs]
                if tstate.enc_kvs is not None else None)
    for tok in forced:
        logits, state = jtfm.decode_step(params, state, jnp.asarray(tok),
                                         cfg, REPLICATED)
        ref["decode"].append(np.asarray(logits))
        tlogits, tstate = ttfm.decode_step(
            model, tstate, torch.as_tensor(tok, dtype=torch.int64), tcfg)
        port["decode"].append(tlogits.numpy())
    ref["final"] = ref_state(state)
    port["final"] = convert.decode_state_to_reference(tstate, tcfg)
    port["enc_ptrs"] = (enc_ptrs, None if tstate.enc_kvs is None else
                        [c.k.data_ptr() for c in tstate.enc_kvs])
    return {"ref": ref, "port": port, "vocab": cfg.vocab_size,
            "n_prefix": tcfg.n_patches}


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _run(case)
        return cache[case]
    return get


def _pairs_close(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for name, (k, v) in want.items():
        gk, gv = got[name]
        assert gk.shape == k.shape and gv.shape == v.shape, name
        assert rel_frobenius(gk, k) <= TOL and rel_frobenius(gv, v) <= TOL


# -- prefill and decode against the reference ---------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_logits_and_position(runs, case):
    r = runs(case)
    ref, port, n = r["ref"], r["port"], r["vocab"]
    assert port["prefill"].shape == ref["prefill"].shape
    assert rel_frobenius(port["prefill"][:, :n], ref["prefill"][:, :n]) <= TOL
    assert port["state"]["pos"] == ref["state"]["pos"] == PROMPT + r[
        "n_prefix"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_self_attention_kv_caches(runs, case):
    r = runs(case)
    _pairs_close(r["port"]["state"]["caches"], r["ref"]["state"]["caches"])
    _pairs_close(r["port"]["final"]["caches"], r["ref"]["final"]["caches"])
    prompt = PROMPT + r["n_prefix"]
    for k, _ in r["port"]["state"]["caches"].values():
        assert not k[:, :, prompt:].any()  # capacity past the prompt


@pytest.mark.parametrize("case", sorted(CASES))
def test_cross_kv_caches(runs, case):
    """whisper: one (n_groups, B, F, KV, hd) pair a layer of the group,
    equal to the reference's after the prefill and carried unchanged
    through every decode step (the same tensors); llava: none."""
    r = runs(case)
    ref, port = r["ref"], r["port"]
    if not case.startswith("whisper"):
        assert ref["state"]["enc_kvs"] is None
        assert port["state"]["enc_kvs"] is None
        return
    _pairs_close(port["state"]["enc_kvs"], ref["state"]["enc_kvs"])
    for name, (k, v) in port["state"]["enc_kvs"].items():
        np.testing.assert_array_equal(port["final"]["enc_kvs"][name][0], k)
        np.testing.assert_array_equal(port["final"]["enc_kvs"][name][1], v)
    before, after = port["enc_ptrs"]
    assert before == after


@pytest.mark.parametrize("case", sorted(CASES))
def test_teacher_forced_decode_logits(runs, case):
    r = runs(case)
    n = r["vocab"]
    assert len(r["port"]["decode"]) == STEPS
    for step, (got, want) in enumerate(zip(r["port"]["decode"],
                                           r["ref"]["decode"])):
        assert rel_frobenius(got[:, :n], want[:, :n]) <= TOL, step
        np.testing.assert_array_equal(got[:, n:], want[:, n:])


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_train_full_logits(case):
    """The full (B, n_prefix + S, vocab) logits and ``n_prefix``; no
    caches and no cross K/V in train mode."""
    cfg, tcfg, params, model = _models(case, seed=2)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, 10)).astype(np.int32)
    extra = lm_extra_inputs(cfg, BATCH, rng)
    want, _, _, _, n_prefix = jtfm.forward(
        params, _inputs(tokens, extra, False), cfg, REPLICATED, "train")
    got, aux, caches, enc, npfx = ttfm.forward(
        model, _inputs(tokens, extra, True), tcfg, "train")
    assert npfx == n_prefix == tcfg.n_patches
    assert caches is None and enc is None and float(aux) == 0
    assert got.shape == (BATCH, 10 + npfx, tcfg.padded_vocab)
    assert rel_frobenius(got.numpy(), np.asarray(want)) <= TOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_prefill_returns_the_states_caches(case):
    """``forward(mode="prefill")`` gives the prefill's caches and cross
    K/V (one a decoder layer) and its last row the prefill's logits."""
    cfg, tcfg, params, model = _models(case)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, 10)).astype(np.int32)
    batch = _inputs(tokens, lm_extra_inputs(cfg, BATCH, rng), True)
    logits, _, caches, enc_kvs, npfx = ttfm.forward(model, batch, tcfg,
                                                    "prefill")
    last, state = ttfm.prefill(model, batch, tcfg)
    assert len(caches) == tcfg.n_layers
    assert rel_frobenius(logits[:, -1], last) <= 1e-6
    for c, s in zip(caches, state.caches):
        torch.testing.assert_close(c.k, s.k, rtol=0, atol=0)
    if tcfg.family == "encdec":
        assert len(enc_kvs) == tcfg.n_layers
        for e, s in zip(enc_kvs, state.enc_kvs):
            assert e.k.shape == (BATCH, tcfg.n_kv_heads, tcfg.n_frames,
                                 tcfg.head_dim)
            torch.testing.assert_close(e.v, s.v, rtol=0, atol=0)
    else:
        assert enc_kvs is None and state.enc_kvs is None


@pytest.mark.parametrize("case", WHISPER)
def test_encoder_output_alone(case):
    cfg, tcfg, params, model = _models(case, seed=4)
    frames = lm_extra_inputs(cfg, BATCH, np.random.default_rng(6))["frames"]
    want = jtfm._encode(params, {"frames": jnp.asarray(frames)}, cfg,
                        REPLICATED)
    got = ttfm._encode(model, {"frames": torch.as_tensor(frames)}, tcfg)
    assert got.shape == (BATCH, tcfg.n_frames, tcfg.d_model)
    assert rel_frobenius(got.numpy(), np.asarray(want)) <= TOL


def test_cross_bias_is_in_decode_only():
    """With ``qkv_bias`` the reference's cross attention adds ``bq`` in
    decode and no bias in prefill, so a prompt's last position decoded
    differs from the forward's last row; the port differs alike."""
    cfg, tcfg, params, model = _models("whisper_qkv_bias", seed=1)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, 9)).astype(np.int32)
    extra = lm_extra_inputs(cfg, BATCH, rng)
    out = {}
    for side, pkg, run in ((False, jtfm, lambda f, *a: f(*a, REPLICATED)),
                           (True, ttfm, lambda f, *a: f(*a))):
        full = _inputs(tokens, extra, side)
        head = dict(full, tokens=full["tokens"][:, :8])
        _, state = run(pkg.prefill, params if not side else model, head,
                       cfg if not side else tcfg)
        step, _ = run(pkg.decode_step, params if not side else model, state,
                      full["tokens"][:, 8], cfg if not side else tcfg)
        fwd = run(pkg.forward, params if not side else model, full,
                  cfg if not side else tcfg)[0]
        out[side] = (np.asarray(step), np.asarray(fwd)[:, -1])
    n = cfg.vocab_size
    (r_step, r_fwd), (t_step, t_fwd) = out[False], out[True]
    assert rel_frobenius(r_step[:, :n], r_fwd[:, :n]) > 100 * TOL
    assert rel_frobenius(t_step[:, :n], r_step[:, :n]) <= TOL
    assert rel_frobenius(t_fwd[:, :n], r_fwd[:, :n]) <= TOL


# -- attention pieces against the reference -----------------------------------

@pytest.mark.parametrize("case", WHISPER)
def test_cross_attention_prefill_and_decode(case):
    """``cross_attention`` (no bias) and ``decode_attention(cross=True)``
    (with ``bq``) on one layer's leaves, against the reference's on the
    same queries and (B, F, KV, hd) encoder K/V."""
    cfg, tcfg, params, _ = _models(case, seed=5)
    p = {k: a[0] for k, a in params["blocks"]["l0"]["cross"].items()}
    layer = tattn.Attention(tcfg, "cpu")
    layer.load_state_dict({k: torch.tensor(a) for k, a in p.items()})
    rng = np.random.default_rng(8)
    x = rng.standard_normal((BATCH, 5, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((BATCH, cfg.n_frames, cfg.d_model)).astype(
        np.float32)
    k = np.einsum("bsd,dhk->bshk", enc, p["wk"])
    v = np.einsum("bsd,dhk->bshk", enc, p["wv"])
    want = jattn.cross_attention(p, jnp.asarray(x), jattn.KVCache(
        jnp.asarray(k), jnp.asarray(v)), cfg, REPLICATED)
    ekv = tattn.cross_kv(layer, torch.as_tensor(enc))
    np.testing.assert_allclose(ekv.k.transpose(1, 2).numpy(), k, rtol=1e-5,
                               atol=1e-5)
    got = tattn.cross_attention(layer, torch.as_tensor(x), ekv, tcfg)
    assert rel_frobenius(got.numpy(), np.asarray(want)) <= TOL
    want1, same = jattn.decode_attention(
        p, jnp.asarray(x[:, :1]), jattn.KVCache(jnp.asarray(k),
                                                jnp.asarray(v)),
        jnp.int32(cfg.n_frames), cfg, REPLICATED, cross=True)
    got1, cache = tattn.decode_attention(layer, torch.as_tensor(x[:, :1]),
                                         ekv, 0, tcfg, cross=True)
    assert cache is ekv
    assert rel_frobenius(got1.numpy(), np.asarray(want1)) <= TOL


def test_noncausal_self_attention_never_attends_the_zero_tail(monkeypatch):
    """An MHA encoder layer given a cache of capacity past S must hand the
    op exactly S keys: over the zero tail the softmax would move (the
    reference has no cache there).  Held to the reference's non-causal
    ``self_attention`` and to the same call without the tail."""
    cfg, tcfg, params, _ = _models("whisper", seed=6)
    p = {k: a[0] for k, a in params["encoder"]["blocks"]["l0"][
        "mixer"].items()}
    layer = tattn.Attention(tcfg, "cpu")
    layer.load_state_dict({k: torch.tensor(a) for k, a in p.items()})
    x = np.random.default_rng(9).standard_normal(
        (BATCH, 10, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(10), (BATCH, 10))
    want, _ = jattn.self_attention(p, jnp.asarray(x), cfg, REPLICATED,
                                   jnp.asarray(pos), causal=False)
    keys = []
    real = tattn.ops.flash_attention

    def spy(q, k, v, **kw):
        keys.append((k.shape[1], kw["causal"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tattn.ops, "flash_attention", spy)
    tpos = torch.tensor(pos)
    for cache_len in (None, 16):
        got, cache = tattn.self_attention(
            layer, torch.as_tensor(x), tcfg, tpos, causal=False,
            return_cache=True, cache_len=cache_len)
        assert cache.k.shape[2] == (cache_len or 10)
        assert rel_frobenius(got.numpy(), np.asarray(want)) <= TOL
    assert keys == [(10, False), (10, False)]


def test_sinusoidal_embedding_equals_the_reference():
    """Within one fp32 ulp of the largest angle, n_pos x 2^-23: the two
    packages' pow may round an angle of up to n_pos radians one ulp
    apart, and sin and cos pass that on."""
    for n_pos, d in ((16, 64), (1500, 768)):
        want = np.asarray(jlayers.sinusoidal_embedding(n_pos, d))
        got = tlayers.sinusoidal_embedding(n_pos, d).numpy()
        assert got.shape == want.shape == (n_pos, d)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=n_pos * 2.0 ** -23)


def test_learned_positions_wrap_at_4096():
    """``embed.pos`` has 4096 rows (not whisper's 448) and a decode step
    at pos 4099 adds row 3, as the reference's ``pos % 4096``: its logits
    on zero caches of capacity 4099 (the ring buffer's wrap) equal the
    reference's."""
    cfg, tcfg, params, model = _models("whisper", seed=3)
    assert model.embed.pos.shape == (tlayers.POS_ROWS, tcfg.d_model) == \
        params["embed"]["pos"].shape
    torch.testing.assert_close(model.embed.position(4099),
                               model.embed.pos[3], rtol=0, atol=0)
    cap = 4099
    state = jtfm.make_decode_state(cfg, BATCH, cap)
    tstate = ttfm.make_decode_state(tcfg, BATCH, cap, device="cpu")
    tok = np.array([5, 17], np.int32)
    want, _ = jtfm.decode_step(params, state, jnp.asarray(tok), cfg,
                               REPLICATED)
    got, _ = ttfm.decode_step(model, tstate, torch.as_tensor(
        tok, dtype=torch.int64), tcfg)
    n = cfg.vocab_size
    assert rel_frobenius(got.numpy()[:, :n], np.asarray(want)[:, :n]) <= TOL


# -- conversions and decode state ---------------------------------------------

@pytest.mark.parametrize("case", ["whisper", "whisper_qkv_bias", "llava"])
def test_params_round_trip_is_exact(case):
    """Every leaf, the encoder's, the cross attention's and ``pos`` too,
    lands on its port key bitwise, and back (``lm_params_to_reference``)."""
    from _torch_parity import lm_params_to_reference
    _, tcfg, params, model = _models(case)
    state = convert.lm_state_dict(params, tcfg)
    assert sorted(state) == sorted(model.state_dict())
    for key, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), state[key])
    keys = set(state)
    if tcfg.family == "encdec":
        assert {"embed.pos", "encoder.norm_f.scale", "layers.1.norm_x.bias",
                "layers.1.cross.wo", "encoder.layers.1.mixer.wq"} <= keys
        assert len(model.encoder.layers) == tcfg.encoder_layers
        assert ("layers.0.cross.bq" in keys) == tcfg.qkv_bias
    else:
        assert not any("cross" in k or "encoder" in k or k == "embed.pos"
                       for k in keys)
    back = _flat(lm_params_to_reference(model, tcfg))
    want = _flat(params)
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v)


def _flat(tree: dict, prefix=()) -> dict:
    """A nested dict's leaves keyed by their paths."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def test_make_decode_state_has_zero_cross_kv():
    """encdec: a zero cross ``KVCache`` (B, KV, n_frames, hd) a decoder
    layer beside the self caches, as the reference's (n_groups, B, F, KV,
    hd); vlm: none."""
    cfg = tconfigs.reduced_config("whisper-small", n_kv_heads=2)
    st = ttfm.make_decode_state(cfg, batch=3, cache_len=9, device="cpu")
    ref = jtfm.make_decode_state(jconfigs.reduced_config(
        "whisper-small", n_kv_heads=2), 3, 9)
    assert st.pos == int(ref.pos) == 9
    assert len(st.enc_kvs) == len(st.caches) == cfg.n_layers
    want = ref.enc_kvs["l0"].k.shape  # (layers, B, F, KV, hd)
    for c in st.enc_kvs:
        assert c.k.shape == (want[1], want[3], want[2], want[4])
        assert c.k.dtype == torch.float32 and not c.k.any()
    back = convert.decode_state_to_reference(st, cfg)
    assert back["enc_kvs"]["l0"][0].shape == want
    vlm = ttfm.make_decode_state(tconfigs.reduced_config("llava-next-34b"),
                                 2, 5, device="cpu")
    assert vlm.enc_kvs is None
    assert convert.decode_state_to_reference(
        vlm, tconfigs.reduced_config("llava-next-34b"))["enc_kvs"] is None


def test_decode_state_to_reference_cross_layout():
    """Layer i's head-major cross K/V lands at [i] of the reference's
    (layers, B, F, KV, hd) stack, bitwise."""
    cfg = tconfigs.reduced_config("whisper-small", n_kv_heads=2)
    g = torch.Generator().manual_seed(0)

    def kv(s):
        return tattn.KVCache(*(torch.randn(2, 2, s, 16, generator=g)
                               for _ in range(2)))
    state = ttfm.DecodeState(caches=[kv(7), kv(7)],
                             enc_kvs=[kv(cfg.n_frames), kv(cfg.n_frames)],
                             pos=5)
    back = convert.decode_state_to_reference(state, cfg)
    k, v = back["enc_kvs"]["l0"]
    assert k.shape == (cfg.n_layers, 2, cfg.n_frames, 2, 16)
    for i, c in enumerate(state.enc_kvs):
        np.testing.assert_array_equal(k[i], c.k.transpose(1, 2).numpy())
        np.testing.assert_array_equal(v[i], c.v.transpose(1, 2).numpy())


# -- the flash op's callers ---------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_operands_and_calls(monkeypatch, case):
    """Every flash call hands the op q (BH, Sq, D) and k, v (BH, Skv, D),
    contiguous and of one dtype.  whisper: a prefill calls it once an
    encoder layer (non-causal, F x F), once a decoder layer for self
    attention (causal) and once for cross attention (non-causal over F
    keys); a decode step twice a decoder layer, the cross call over the
    state's cross cache itself (no copy).  llava: once a layer, causal,
    over patches and prompt."""
    _, tcfg, _, model = _models(case)
    real = tattn.ops.flash_attention
    calls = []

    def spy(q, k, v, causal=True, scale=None, q_offset=0, **kw):
        for t in (q, k, v):
            assert t.ndim == 3 and t.is_contiguous() and t.dtype == q.dtype
        assert k.shape == v.shape and k.shape[0] == q.shape[0]
        calls.append((q.shape[1], k.shape[1], causal, k.data_ptr()))
        return real(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                    **kw)

    rng = np.random.default_rng(2)
    tokens = rng.integers(0, tcfg.vocab_size, (BATCH, PROMPT))
    batch = _inputs(tokens, lm_extra_inputs(tcfg, BATCH, rng), True)
    monkeypatch.setattr(tattn.ops, "flash_attention", spy)
    _, st = ttfm.prefill(model, batch, tcfg, cache_len=PROMPT + 4
                         + tcfg.n_patches)
    L, F, G = tcfg.n_layers, tcfg.n_frames, tcfg.group_size
    s = PROMPT + tcfg.n_patches
    # MHA attends the self cache in place (its capacity s + 4); GQA and
    # padded heads a copy of its s keys expanded to the query heads
    in_place = tcfg.padded_heads == tcfg.n_kv_heads
    self_keys = s + 4 if in_place else s
    if tcfg.family == "encdec":
        enc, dec = calls[:tcfg.encoder_layers], calls[tcfg.encoder_layers:]
        assert [c[:3] for c in enc] == [(F, F, False)] * tcfg.encoder_layers
        assert [c[:3] for c in dec] == [(s, self_keys, True),
                                        (G * s, F, False)] * L
        # without padded heads the cross prefill attends the state's
        # cross cache (no copy)
        assert ([c[3] for c in dec[1::2]] == [e.k.data_ptr()
                                              for e in st.enc_kvs]) == (
            tcfg.padded_heads == tcfg.n_heads)
    else:
        assert [c[:3] for c in calls] == [(s, self_keys, True)] * L
    calls.clear()
    _, st = ttfm.decode_step(model, st, torch.as_tensor(tokens[:, 0]), tcfg)
    if tcfg.family == "encdec":
        assert [c[:3] for c in calls[1::2]] == [(G, F, False)] * L
        assert [c[3] for c in calls[1::2]] == [e.k.data_ptr()
                                               for e in st.enc_kvs]
        assert len(calls) == 2 * L
    else:
        assert len(calls) == L and all(c[0] == G for c in calls)


# -- the serving CLI ----------------------------------------------------------

def _serve(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        gen = serve.main(argv, device="cpu")
    return gen, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ["whisper-small", "llava-next-34b"])
def test_serve_main_repeats_under_its_seed(arch):
    argv = ["--arch", arch, "--reduced", "--batch", "3", "--prompt-len",
            "6", "--gen-len", "5", "--seed", "4"]
    a, line = _serve(argv)
    b, _ = _serve(argv)
    assert a.shape == (3, 5) and a.dtype == np.int32
    assert line["arch"] == arch and line["generated_shape"] == [3, 5]
    np.testing.assert_array_equal(a, b)
    c, _ = _serve(argv[:-1] + ["5"])
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("arch", ["whisper-small", "llava-next-34b"])
def test_generate_takes_given_frames_or_patches(arch):
    """``generate``'s zero frames / patches are the CLI's; given ones
    (cast to the model's dtype) change what is generated, and feeding
    zeros gives the CLI's tokens."""
    cfg = tconfigs.reduced_config(arch)
    key, n = (("frames", cfg.n_frames) if cfg.family == "encdec"
              else ("patches", cfg.n_patches))
    kw = dict(batch=2, prompt_len=5, gen_len=4, seed=2, device="cpu")
    zeros, _ = serve.generate(cfg, **kw)
    same, _ = serve.generate(cfg, **kw, **{key: torch.zeros(
        2, n, cfg.d_model, dtype=torch.float64)})
    np.testing.assert_array_equal(zeros, same)
    given = torch.randn(2, n, cfg.d_model,
                        generator=torch.Generator().manual_seed(0))
    other, _ = serve.generate(cfg, **kw, **{key: given})
    assert other.shape == (2, 4) and not np.array_equal(zeros, other)
