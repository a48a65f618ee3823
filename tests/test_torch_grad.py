"""Gradients of the port's LM (``repro_torch.models.transformer.loss_fn``)
against ``jax.value_and_grad`` of the reference's ``tfm.loss_fn`` (under
``REPLICATED``), and the two differentiable ops (``kernels.grad``)
against autograd through their plain versions, on the CPU in fp32.

Every case of ``tests/test_torch_lm.py`` (the dense family: MHA, GQA,
MQA, ``qkv_bias``, the reference's chunked attention and padded heads;
then ``FAMILIES``: falcon-mamba, arctic, llama4, the jamba stand-in and
jamba's period, whisper and its variants, llava) on the reference's
weights carried by ``convert`` and one seeded batch of 2 x 16 tokens
(with seeded frames or patches): the loss, its ``ce`` and ``aux``, and
every parameter's gradient within relative Frobenius ``TOL`` (1e-5, the
forward parity's bound: both sum in fp32 in other orders; the 2-layer
models measured about 1e-6); a gradient that is zero in exact arithmetic
(``ZERO``) is held, in both packages, below 1e-6 of the whole gradient's
norm.  Reduced olmo-1b with the
reference's own initial weights at B 2 x 32 gives the loss 6.0837 and
gradient norm 13.84 that the roadmap's probe recorded.

One train step (gradients, then AdamW) against the reference's: the new
parameters within relative Frobenius ``TOL``.  Four steps of reduced
olmo-1b at lr 3e-3 with rank-4 gradient compression of every matrix
(``compress_tree`` on the reference's layer-stacked layout, the
reference's initial subspaces carried across) and int8 or fp32 moments,
on the synthetic pipeline's batches, each package on its own
trajectory: every loss within ``TOL`` of the other's, both falling.  At
each step, from the reference's state and gradients: the port's
``compress_tree``, and the reference's, within ``TOL`` + kappa x 2^-23
of the same arithmetic in float64 with an exact eigh, kappa the r x r
Gram's condition number (fp32 rounding of the Gram moves its inverse
square root by about kappa units of rounding; the Gram of the second
step is ill-conditioned, kappa up to about 3e5, so the compressed
gradient moves by more than ``TOL`` in both packages), and the port's
AdamW of the reference's compressed gradients within ``TOL`` of the
reference's new parameters.
``remat`` on and off: bitwise-equal gradients (the recompute runs the
same ops on the same values).  The MoE's dispatch (slot copies into a buffer with a spare
row) against ``jax.grad`` of the reference's scatter-add dispatch, with
dropped assignments and a share of the experts.

The ops: ``ops.flash_attention``'s gradients (its ``Function``'s chunked
FlashAttention-2 backward) against autograd through
``kernels.ref.flash_attention`` within 1e-5 relative Frobenius, at
several (Sq, Skv, D, causal, q_offset, chunk); with bf16 operands, each
gradient within one bf16 ulp of the larger value plus 2e-5 x max |want|
of the plain fp32 gradients of the same operands (the backward computes
in fp32 and rounds once).  ``ops.mamba_scan``'s gradients (the chunked
adjoint) against autograd through ``kernels.ref.mamba_scan`` within 1e-5,
with and without the final state's gradient.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.parallel.sharding import REPLICATED
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs.shapes import ShapeCell
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps as tsteps
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcomp

from _torch_parity import (bf16_ulp, compression_state_to_port,
                           lm_extra_inputs, ref_lm_params, rel_frobenius)
from test_torch_lm import CASES, FAMILIES

TOL = 1e-5
# a gradient that is zero in exact arithmetic (a key bias without rope:
# it moves every score of a row alike, which softmax ignores; the decoder's
# cross-attention biases, which the reference's train form does not add)
# comes back as rounding residue or zeros, held below this share of the
# whole gradient's norm in both packages
ZERO = 1e-6
BATCH, SEQ = 2, 16
ALL = {**CASES, **FAMILIES}
STEP_CASES = ["olmo_mha", "falcon_mamba", "jamba_2layer", "arctic_moe",
              "whisper", "llava"]


def _setup(case, seq=SEQ, params=None):
    arch, overrides = ALL[case]
    cfg = jconfigs.reduced_config(arch, **overrides)
    tcfg = tconfigs.reduced_config(arch, **overrides)
    params = ref_lm_params(cfg) if params is None else params
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, seq)).astype(np.int32)
    extra = lm_extra_inputs(cfg, BATCH, rng)
    return cfg, tcfg, params, tokens, extra


def _ref_grads(cfg, params, tokens, extra):
    batch = {"tokens": jnp.asarray(tokens),
             **{k: jnp.asarray(v) for k, v in extra.items()}}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, batch, cfg, REPLICATED), has_aux=True))(
        params)
    return loss, metrics, grads


@functools.lru_cache(maxsize=None)
def _reference(case):
    """(setup, the reference's loss, metrics and gradients) of a case,
    computed once for the tests that share it."""
    setup = _setup(case)
    return setup, _ref_grads(*[setup[i] for i in (0, 2, 3, 4)])


def _port_grads(model, tcfg, tokens, extra):
    batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int64),
             **{k: torch.as_tensor(v) for k, v in extra.items()}}
    loss, metrics = ttfm.loss_fn(model, batch, tcfg)
    loss.backward()
    # a parameter the loss does not reach (the cross attention's biases)
    # has no gradient: the reference's is zeros
    return loss.detach(), metrics, {
        k: torch.zeros_like(p) if p.grad is None else p.grad
        for k, p in model.named_parameters()}


def _hold(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    total = np.sqrt(sum(float(np.sum(np.square(w, dtype=np.float64)))
                        for w in want.values()))
    for k, w in want.items():
        if np.linalg.norm(w) <= ZERO * total:   # an exact zero's residue
            assert float(torch.linalg.norm(got[k])) <= ZERO * total, k
            continue
        err = rel_frobenius(got[k], w)
        assert err <= TOL, f"{k}: rel-Frobenius {err:.3e} > {TOL:g}"


@pytest.mark.parametrize("case", sorted(ALL))
def test_loss_and_gradients_match_reference(case):
    (cfg, tcfg, params, tokens, extra), (loss, metrics, grads) = \
        _reference(case)
    model = convert.lm_params_to_port(params, tcfg,
                                      device="cpu").requires_grad_(True)
    tloss, tmetrics, tgrads = _port_grads(model, tcfg, tokens, extra)
    assert abs(float(tloss) - float(loss)) <= TOL * abs(float(loss))
    assert abs(float(tmetrics["ce"]) - float(metrics["ce"])) <= \
        TOL * abs(float(metrics["ce"]))
    assert abs(float(tmetrics["aux"]) - float(metrics["aux"])) <= \
        TOL * max(abs(float(metrics["aux"])), 1e-6)
    _hold(tgrads, convert.lm_state_dict(jax.tree.map(np.asarray, grads),
                                        tcfg))


def test_reduced_olmo_reproduces_the_probe():
    cfg = jconfigs.reduced_config("olmo-1b")
    params = jax.tree.map(np.asarray, jtfm.param_values(
        jtfm.init_model(jax.random.PRNGKey(0), cfg)))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    loss, _, grads = _ref_grads(cfg, params, tokens, {})
    tcfg = tconfigs.reduced_config("olmo-1b")
    model = convert.lm_params_to_port(params, tcfg,
                                      device="cpu").requires_grad_(True)
    tloss, _, tgrads = _port_grads(model, tcfg, tokens, {})
    norm = float(tadamw.global_norm(tgrads))
    assert round(float(tloss), 4) == round(float(loss), 4) == 6.0837
    assert round(norm, 2) == round(float(jadamw.global_norm(grads)),
                                   2) == 13.84


@pytest.mark.parametrize("case", STEP_CASES)
def test_one_train_step_matches_reference(case):
    (cfg, tcfg, params, tokens, extra), (_, _, grads) = _reference(case)
    ocfg = dict(lr=1e-3, warmup_steps=1, decay_steps=10)
    new, _, _ = jadamw.update(grads, jadamw.init(params, jadamw.AdamWConfig(
        **ocfg)), params, jadamw.AdamWConfig(**ocfg))
    model = convert.lm_params_to_port(params, tcfg,
                                      device="cpu").requires_grad_(True)
    _, _, tgrads = _port_grads(model, tcfg, tokens, extra)
    p = dict(model.named_parameters())
    tadamw.update(tgrads, tadamw.init(p, tadamw.AdamWConfig(**ocfg)), p,
                  tadamw.AdamWConfig(**ocfg))
    want = convert.lm_state_dict(jax.tree.map(np.asarray, new), tcfg)
    for k, w in want.items():
        err = rel_frobenius(p[k], w)
        assert err <= TOL, f"{k}: rel-Frobenius {err:.3e} > {TOL:g}"


def _compressed64(grads: dict, state) -> dict:
    """``compress_tree``'s arithmetic in float64 with an exact eigh: for
    each compressed leaf of ``grads`` (the reference's layout, dotted
    names), from ``state``, (its compressed gradient, the condition
    number of its r x r Gram)."""
    out = {}
    for k, q in state.q.items():
        if q is None:
            continue
        g = np.asarray(grads[k], np.float64)
        g2 = g.reshape(-1, g.shape[-1]) + np.asarray(
            state.error[k], np.float64).reshape(-1, g.shape[-1])
        p = g2 @ np.asarray(q, np.float64)
        w, v = np.linalg.eigh(p.T @ p)
        p = p @ (v @ np.diag(1 / np.sqrt(np.maximum(w, 1e-12))) @ v.T)
        out[k] = (p @ (g2.T @ p).T).reshape(g.shape), w.max() / w.min()
    return out


@pytest.mark.parametrize("moment_dtype", ["int8", "float32"])
def test_compressed_steps_match_reference(moment_dtype):
    steps, batch, seq = 4, 4, 64
    cfg = jconfigs.reduced_config("olmo-1b")
    tcfg = tconfigs.reduced_config("olmo-1b")
    params = jax.tree.map(np.asarray, jtfm.param_values(
        jtfm.init_model(jax.random.PRNGKey(0), cfg)))
    ocfg = dict(lr=3e-3, moment_dtype=moment_dtype, warmup_steps=2,
                decay_steps=steps)
    ccfg = dict(rank=4, min_size=4096)   # every matrix of the reduced model
    jo, jc = jadamw.AdamWConfig(**ocfg), jcomp.CompressionConfig(**ccfg)
    to, tc = tadamw.AdamWConfig(**ocfg), tcomp.CompressionConfig(**ccfg)
    jstate = (params, jadamw.init(params, jo),
              jcomp.init_state(params, jc, jax.random.PRNGKey(1)))
    step, _ = tsteps.build_train_step(
        tcfg, ShapeCell("c", seq, batch, "train"), to, tc, device="cpu")
    own = tsteps.TrainState(
        convert.lm_params_to_port(params, tcfg,
                                  device="cpu").requires_grad_(True),
        convert.adamw_state_to_port(jstate[1], tcfg, device="cpu"),
        torch.tensor(0, dtype=torch.int32),
        compression_state_to_port(jstate[2]))
    p = dict(own.params.named_parameters())
    assert {k for k, q in own.comp.q.items() if q is not None} == set(
        tsteps.stack_layers(p, tcfg)) - {"norm_f.scale"} == {
        "embed.tok", "embed.head", *(f"blocks.l0.{n}" for n in (
            "mixer.wq", "mixer.wk", "mixer.wv", "mixer.wo", "ffn.wi",
            "ffn.wo", "ffn.wg"))}

    @jax.jit
    def jstep(state, tokens):
        params, opt, comp = state
        (loss, _), grads = jax.value_and_grad(
            lambda q: jtfm.loss_fn(q, {"tokens": tokens}, cfg, REPLICATED),
            has_aux=True)(params)
        cgrads, comp, _ = jcomp.compress_tree(grads, comp, jc)
        params, opt, _ = jadamw.update(cgrads, opt, params, jo)
        return (params, opt, comp), loss, grads, cgrads

    def dotted(tree) -> dict:
        return {".".join(part[2:-2] for part in path): np.asarray(a)
                for path, a in jcomp._flatten(tree).items()}

    pipe = TokenPipeline(DataConfig(seq_len=seq, global_batch=batch,
                                    vocab_size=cfg.vocab_size, seed=0))
    losses = []
    for k in range(steps):
        tokens = pipe.batch_at(k)[:, :seq]
        own, metrics = step(own, {"tokens": tokens})
        before = jstate
        jstate, loss, grads, cgrads = jstep(jstate, jnp.asarray(tokens))
        losses.append((float(loss), float(metrics["loss"])))
        assert abs(losses[-1][1] - losses[-1][0]) <= TOL * losses[-1][0]
        # compression of the reference's gradients from its state, both
        # packages against float64 arithmetic
        grads, cgrads = dotted(grads), dotted(cgrads)
        state = compression_state_to_port(before[2])
        got, _, _ = tcomp.compress_tree(
            {n: torch.as_tensor(g) for n, g in grads.items()}, state, tc)
        for n, (want, kappa) in _compressed64(grads, state).items():
            bound = TOL + kappa * 2.0 ** -23
            for who, c in (("port", got[n]), ("reference", cgrads[n])):
                err = rel_frobenius(c, want)
                assert err <= bound, \
                    f"step {k} {n} ({who}): {err:.3e} > {bound:.3e}"
        # AdamW of the reference's compressed gradients from its state
        model = convert.lm_params_to_port(
            jax.tree.map(np.asarray, before[0]), tcfg, device="cpu")
        q = dict(model.named_parameters())
        tadamw.update(tsteps.unstack_layers(
            {n: torch.as_tensor(g) for n, g in cgrads.items()}, q, tcfg),
            convert.adamw_state_to_port(before[1], tcfg, device="cpu"), q,
            to)
        want = convert.lm_state_dict(jax.tree.map(np.asarray, jstate[0]),
                                     tcfg)
        for name, w in want.items():
            err = rel_frobenius(q[name], w)
            assert err <= TOL, f"step {k} {name}: {err:.3e} > {TOL:g}"
    assert losses[-1][0] < losses[0][0] and losses[-1][1] < losses[0][1]


@pytest.mark.parametrize("case", ["olmo_mha", "falcon_mamba",
                                  "jamba_2layer", "whisper", "llava"])
def test_remat_gives_bitwise_equal_gradients(case):
    _, tcfg, params, tokens, extra = _setup(case)
    out = []
    for remat in (False, True):
        c = dataclasses.replace(tcfg, remat=remat)
        model = convert.lm_params_to_port(params, c,
                                          device="cpu").requires_grad_(True)
        loss, _, grads = _port_grads(model, c, tokens, extra)
        out.append((loss, grads))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_serving_models_build_no_graph():
    tcfg = tconfigs.reduced_config("olmo-1b")
    model = ttfm.init_model(tcfg, seed=0, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    logits, *_ = ttfm.forward(model, {"tokens": torch.zeros(
        1, 8, dtype=torch.int64)}, tcfg, "train")
    assert logits.grad_fn is None
    trained = ttfm.init_model(tcfg, seed=0, device="cpu", train=True)
    assert all(p.requires_grad for p in trained.parameters())
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 trained.parameters()))
    logits, *_ = ttfm.forward(trained, {"tokens": torch.zeros(
        1, 8, dtype=torch.int64)}, tcfg, "prefill")
    assert logits.grad_fn is None


# -- the MoE's dispatch ---------------------------------------------------------

@pytest.mark.parametrize("C,e0,E_local", [(2, 0, 4), (5, 0, 4), (3, 1, 2)])
def test_moe_dispatch_gradients_match_reference(C, e0, E_local):
    rng = np.random.default_rng(C + e0)
    T, d, f, E, k = 12, 8, 16, 4, 2
    xf = rng.standard_normal((T, d)).astype(np.float32)
    gate = rng.random((T, k)).astype(np.float32)
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(
        np.int32)
    w = [(rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
         for s in ((E_local, d, f), (E_local, d, f), (E_local, f, d))]
    dy = rng.standard_normal((T, d)).astype(np.float32)
    kw = dict(E=E, k=k, C=C, e0=e0, E_local=E_local)

    def ref_loss(xf, gate, wi, wg, wo):
        y = jmoe._dispatch_compute_combine(xf, gate, jnp.asarray(idx), wi,
                                           wg, wo, **kw)
        return jnp.sum(y * dy)

    want = jax.grad(ref_loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (xf, gate, *w)))
    args = [torch.tensor(a, requires_grad=True) for a in (xf, gate, *w)]
    y = tmoe._dispatch_compute_combine(
        args[0], args[1], torch.as_tensor(idx, dtype=torch.int64), *args[2:],
        **kw)
    (y * torch.tensor(dy)).sum().backward()
    dropped = int((tmoe.positions(torch.as_tensor(idx.T.reshape(-1),
                                                  dtype=torch.int64), E)
                   >= C).sum())
    assert C > 4 or dropped > 0      # the small capacities drop some
    for a, w_ in zip(args, want):
        assert rel_frobenius(a.grad, np.asarray(w_)) <= TOL


# -- the two differentiable ops -------------------------------------------------

def _plain_grads(fn, args, cot):
    args = [a.detach().float().requires_grad_(True) for a in args]
    out = fn(*args)
    outs = out if isinstance(out, tuple) else (out,)
    cots = cot if isinstance(cot, tuple) else (cot,)
    torch.autograd.backward([o for o, c in zip(outs, cots) if c is not None],
                            [c.float() for c in cots if c is not None])
    return [a.grad for a in args]


ATTN_SHAPES = [  # (BH, Sq, Skv, D, causal, q_offset, chunk)
    (3, 37, 37, 16, True, 0, 16),
    (3, 12, 40, 16, True, 28, 8),
    (2, 9, 50, 20, False, 0, 16),
    (2, 64, 64, 32, True, 0, 64),
    (2, 64, 64, 32, True, 0, 1024),
    (4, 5, 33, 8, True, 3, 7),
]


@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=str)
def test_flash_attention_gradients_match_plain(shape):
    bh, sq, skv, d, causal, q_offset, chunk = shape
    g = torch.Generator().manual_seed(sq * skv + d)
    q, k, v = (torch.randn(bh, n, d, generator=g, requires_grad=True)
               for n in (sq, skv, skv))
    dout = torch.randn(bh, sq, d, generator=g)
    out = ops.flash_attention(q, k, v, causal=causal, scale=d ** -0.5,
                              q_offset=q_offset, chunk=chunk)
    assert out.grad_fn is not None and "FlashAttention" in out.grad_fn.name()
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = _plain_grads(lambda *a: ref.flash_attention(
        *a, causal=causal, scale=d ** -0.5, q_offset=q_offset), (q, k, v),
        dout)
    for a, b in zip(got, want):
        assert rel_frobenius(a, b) <= TOL


@pytest.mark.parametrize("shape", ATTN_SHAPES[:4], ids=str)
def test_flash_attention_bf16_gradients_round_once(shape):
    bh, sq, skv, d, causal, q_offset, chunk = shape
    g = torch.Generator().manual_seed(sq + skv + d)
    q, k, v = (torch.randn(bh, n, d, generator=g).to(torch.bfloat16)
               .requires_grad_(True) for n in (sq, skv, skv))
    dout = torch.randn(bh, sq, d, generator=g).to(torch.bfloat16)
    out = ops.flash_attention(q, k, v, causal=causal, scale=d ** -0.5,
                              q_offset=q_offset, chunk=chunk)
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = _plain_grads(lambda *a: ref.flash_attention(
        *a, causal=causal, scale=d ** -0.5, q_offset=q_offset), (q, k, v),
        dout)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        a = a.float()
        slack = bf16_ulp(torch.maximum(a.abs(), b.abs())) \
            + 2e-5 * float(b.abs().max())
        assert bool(((a - b).abs() <= slack).all())


def _exact_attention_grads(q, k, v, dout, causal, scale, q_offset):
    """Autograd through softmax attention in float64."""
    a = [t.detach().double().requires_grad_(True) for t in (q, k, v)]
    s = a[0] @ a[1].mT * scale
    if causal:
        rows = torch.arange(q.shape[1])[:, None] + q_offset
        s = s.masked_fill(rows < torch.arange(k.shape[1])[None, :],
                          float("-inf"))
    return torch.autograd.grad(torch.softmax(s, -1) @ a[2], a,
                               dout.double())


@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=str)
def test_flash_attention_gradients_hold_with_a_common_key_part(shape):
    """Keys with a common part (whisper's cross attention attends its
    encoder's output, where it is large): every gradient within 2e-5 x
    its max |exact| of the float64 gradients (chip_smoke's attention
    gradient bound less the bf16 rounding).  Each row of dS sums to zero,
    so dQ takes the keys less their mean; without that dQ was off by
    7.8e-5 to 1.9e-4 x max |dQ| at a common part of 4 to 20."""
    bh, sq, skv, d, causal, q_offset, chunk = shape
    g = torch.Generator().manual_seed(sq * skv + d)
    q = torch.randn(bh, sq, d, generator=g, requires_grad=True)
    k = (0.3 * torch.randn(bh, skv, d, generator=g) + 8.0).requires_grad_()
    v = (torch.randn(bh, skv, d, generator=g) + 2.0).requires_grad_()
    dout = torch.randn(bh, sq, d, generator=g)
    out = ops.flash_attention(q, k, v, causal=causal, scale=d ** -0.5,
                              q_offset=q_offset, chunk=chunk)
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = _exact_attention_grads(q, k, v, dout, causal, d ** -0.5,
                                  q_offset)
    for name, a, b in zip("qkv", got, want):
        err = float((a.double() - b).abs().max() / b.abs().max())
        assert err <= 2e-5, (name, err)


@pytest.mark.parametrize("return_state", [False, True])
@pytest.mark.parametrize("shape", [(2, 37, 6, 4, 8), (1, 16, 5, 3, 16),
                                   (3, 20, 4, 2, 256), (1, 9, 3, 5, 1)],
                         ids=str)
def test_mamba_scan_gradients_match_plain(shape, return_state):
    b, length, d, n, chunk = shape
    g = torch.Generator().manual_seed(length * d + n)
    u = torch.randn(b, length, d, generator=g)
    dt = torch.rand(b, length, d, generator=g) * 0.5
    A = -torch.rand(d, n, generator=g) * 2
    B, C = (torch.randn(b, length, n, generator=g) for _ in range(2))
    D = torch.randn(d, generator=g)
    args = [t.requires_grad_(True) for t in (u, dt, A, B, C, D)]
    dy = torch.randn(b, length, d, generator=g)
    dstate = torch.randn(b, d, n, generator=g) if return_state else None
    out = ops.mamba_scan(*args, chunk=chunk, return_state=return_state)
    outs = out if return_state else (out,)
    cots = (dy, dstate) if return_state else (dy,)
    got = torch.autograd.grad(outs, args, cots)
    want = _plain_grads(lambda *a: ref.mamba_scan(
        *a, return_state=return_state), args, cots)
    for a, w in zip(got, want):
        assert rel_frobenius(a, w) <= TOL


def test_ops_without_gradients_take_no_function():
    q = torch.randn(2, 8, 16)
    out = ops.flash_attention(q, q, q, causal=True)
    assert out.grad_fn is None
    with torch.no_grad():
        out = ops.flash_attention(q.requires_grad_(True), q, q)
    assert out.grad_fn is None


def test_remat_recompute_keeps_the_scoped_backend():
    """On the card autograd runs the backward, and so the recompute, on a
    thread of its own; the recompute must run the ops the forward ran.
    Here the backward runs on another thread, the process default names
    the ``cuda`` backend (which refuses CPU tensors), and the forward ran
    under ``use_backend("torch")``."""
    import threading
    from repro_torch.backends import registry
    tcfg = dataclasses.replace(tconfigs.reduced_config("olmo-1b"),
                               remat=True)
    model = ttfm.init_model(tcfg, seed=0, device="cpu", train=True)
    tokens = torch.zeros(1, 8, dtype=torch.int64)
    errors = []
    registry.set_default_backend("cuda")
    try:
        with registry.use_backend("torch"):
            loss, _ = ttfm.loss_fn(model, {"tokens": tokens}, tcfg)

        def backward():
            try:
                loss.backward()
            except RuntimeError as e:      # the cuda backend's refusal
                errors.append(e)

        th = threading.Thread(target=backward)
        th.start()
        th.join(60)
        assert not th.is_alive()
    finally:
        registry.set_default_backend(None)
    assert not errors, errors
    assert all(p.grad is not None for p in model.parameters())
