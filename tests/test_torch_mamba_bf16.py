"""``ssm_dtype="bfloat16"`` in the port against the reference on the CPU:
the scan's state kept in bf16, at reduced falcon-mamba (d 64, d_inner
128, N 8) and the 2-layer jamba stand-in, fp32 weights.

The reference rounds its bf16 scan at points the port's plain version
copies (``kernels.ref.mamba_scan``), but it scans each chunk
associatively, so the two round other partial products: no bitwise
parity.  The contract is bf16's own noise.  For each quantity (the op's
y and final state, the layer's output and cache, decode outputs, logits,
each gradient) let d_ref be the relative Frobenius distance between the
reference's bf16-state run and its fp32-state run on the same inputs:
the port's bf16-state result lies within ``NOISE`` x d_ref of both, and
d_ref > 0.  Beside it: the port's final state holds bf16 values (a round
trip through bf16 leaves it unchanged), and the port's bf16 result lies
at least ``APART`` x d_ref from its own fp32 result, so a port that ran
the fp32 state whatever it was asked (fp32 rounding, 1e-6 and below,
from its fp32 result) passes no test here.  Not more than a tenth: the
reference's ``jax.grad`` takes its bf16 scan's cotangents in bf16 and
the port's adjoint runs in fp32, so the port's bf16 gradients lie nearer
the fp32 ones than the reference's (0.44 d_ref for a ``dt_b``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import mamba as jmamba
from repro.models import transformer as jtfm
from repro.parallel.sharding import REPLICATED
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.kernels import mamba_scan as kscan
from repro_torch.kernels import ops, ref
from repro_torch.models import mamba as tmamba
from repro_torch.models import transformer as ttfm

from _torch_parity import ref_lm_params, rel_frobenius, to_numpy
from test_torch_mamba import ARCH, _pair, _x

NOISE = 2.0
APART = 0.1
BF16 = {"ssm_dtype": "bfloat16"}
JAMBA_2 = {"n_layers": 2, "attn_every": 2, "moe_every": 2}
MODELS = {"falcon_mamba": ("falcon-mamba-7b", {}),
          "jamba_2layer": ("jamba-v0.1-52b", JAMBA_2)}


def _hold(port, ref16, ref32, what: str = "") -> float:
    """The noise contract; returns d_ref."""
    port, ref16, ref32 = (to_numpy(a) for a in (port, ref16, ref32))
    d_ref = rel_frobenius(ref16, ref32)
    assert d_ref > 0, f"{what}: the reference's bf16 state changed nothing"
    to16, to32 = rel_frobenius(port, ref16), rel_frobenius(port, ref32)
    assert to16 <= NOISE * d_ref, f"{what}: {to16:.3e} from the " \
        f"reference's bf16 run, d_ref {d_ref:.3e}"
    assert to32 <= NOISE * d_ref, f"{what}: {to32:.3e} from the " \
        f"reference's fp32 run, d_ref {d_ref:.3e}"
    return d_ref


def _apart(port16, port32, d_ref: float, what: str = "") -> None:
    gap = rel_frobenius(to_numpy(port16), to_numpy(port32))
    assert gap >= APART * d_ref, f"{what}: the port's bf16 result is " \
        f"{gap:.3e} from its fp32 result, d_ref {d_ref:.3e}"


def _bf16_values(t: torch.Tensor) -> None:
    assert t.dtype == torch.float32
    assert torch.equal(t.bfloat16().float(), t)


# -- the op -------------------------------------------------------------------

def _ref_scan(u, dt, A, B, C, D, chunk: int, ssm_dtype: str):
    """The reference's scan as ``apply_mamba`` runs it (the casts, the
    chunk rule, ``_chunked_scan``, the fp32 einsum and D u): (y, the
    final state in fp32)."""
    sdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[ssm_dtype]
    s = u.shape[1]
    dtc = dt.astype(sdt)
    a = jnp.exp(dtc[..., None] * A.astype(sdt)[None, None])
    b = (dtc * u.astype(sdt))[..., None] * B.astype(sdt)[:, :, None, :]
    cs = max(1, min(chunk, s))
    while s % cs:
        cs -= 1
    states = jmamba._chunked_scan(a, b, cs)
    y = jnp.einsum("bsdn,bsn->bsd", states, C.astype(sdt),
                   preferred_element_type=jnp.float32) + D * u
    return y, states[:, -1].astype(jnp.float32)


def _scan_args(b, L, d, n, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(a.astype(np.float32) for a in (
        rng.standard_normal((b, L, d)), rng.uniform(0.01, 0.2, (b, L, d)),
        -rng.uniform(0.5, 8.0, (d, n)), rng.standard_normal((b, L, n)),
        rng.standard_normal((b, L, n)), rng.standard_normal(d)))


# (batch, L, D, N, mamba_chunk): L a multiple of the chunk; L prime (the
# reference's chunk falls to 1); L = 100 over chunks of 10 (the largest
# divisor under 16); N = 1 and a longer scan
SCAN_CASES = [(2, 16, 12, 16, 8), (2, 37, 12, 8, 16), (2, 100, 16, 4, 16),
              (1, 64, 8, 1, 64), (1, 256, 32, 16, 64)]


@pytest.mark.parametrize("case", SCAN_CASES)
def test_plain_op_against_the_reference_scan(case):
    b, L, d, n, chunk = case
    args = _scan_args(b, L, d, n)
    jargs = [jnp.asarray(a) for a in args]
    y16, s16 = _ref_scan(*jargs, chunk, "bfloat16")
    y32, s32 = _ref_scan(*jargs, chunk, "float32")
    targs = [torch.from_numpy(a) for a in args]
    for fn in (lambda *a, **k: ops.mamba_scan(*a, chunk=chunk, **k),
               lambda *a, **k: ops.mamba_scan(*a, backend="torch", **k),
               ref.mamba_scan, kscan.mamba_scan):
        y, state = fn(*targs, return_state=True, state_dtype=torch.bfloat16)
        assert y.shape == (b, L, d) and state.shape == (b, d, n)
        d_y = _hold(y, y16, y32, "y")
        d_s = _hold(state, s16, s32, "final state")
        _bf16_values(state)
        y_fp32, s_fp32 = fn(*targs, return_state=True)
        _apart(y, y_fp32, d_y, "y")
        _apart(state, s_fp32, d_s, "final state")
        # the default call is y alone, the same values
        assert torch.equal(fn(*targs, state_dtype=torch.bfloat16), y)


def test_bf16_state_of_bf16_operands():
    """bf16 u, dt, B, C: rounding them again changes nothing, so the
    result is the fp32 operands' bf16-state result rounded to bf16."""
    args = [torch.from_numpy(a) for a in _scan_args(2, 19, 8, 16, seed=3)]
    args16 = [t.bfloat16() if t.ndim == 3 else t for t in args]
    y, state = ref.mamba_scan(*args16, return_state=True,
                              state_dtype=torch.bfloat16)
    want_y, want_state = ref.mamba_scan(*(t.float() for t in args16),
                                        return_state=True,
                                        state_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16
    assert torch.equal(state, want_state)
    assert torch.equal(y, want_y.bfloat16())


@pytest.mark.parametrize("state_dtype", [torch.float16, torch.float64])
def test_scan_op_refuses_other_state_dtypes(state_dtype):
    args = [torch.from_numpy(a) for a in _scan_args(1, 4, 3, 2)]
    for fn in (ops.mamba_scan, ref.mamba_scan, kscan.mamba_scan):
        with pytest.raises(ValueError, match="state_dtype"):
            fn(*args, state_dtype=state_dtype)


def _scan_loss_ref(u, dt, A, B, C, D, w, v, chunk, ssm_dtype):
    y, state = _ref_scan(u, dt, A, B, C, D, chunk, ssm_dtype)
    return jnp.sum(y * w) + jnp.sum(state * v)


@pytest.mark.parametrize("case", [(2, 24, 8, 8, 8), (1, 37, 12, 16, 16)])
def test_scan_op_gradients_against_jax(case):
    """The op's backward in bf16-state mode (the chunked adjoint on the
    rounded values) against ``jax.value_and_grad`` of the reference's
    bf16 scan, a weighted sum of y and of the final state."""
    b, L, d, n, chunk = case
    args = _scan_args(b, L, d, n, seed=4)
    rng = np.random.default_rng(5)
    w = rng.standard_normal((b, L, d)).astype(np.float32)
    v = rng.standard_normal((b, d, n)).astype(np.float32)
    want = {}
    for sd in ("bfloat16", "float32"):
        want[sd] = jax.grad(_scan_loss_ref, argnums=tuple(range(6)))(
            *(jnp.asarray(a) for a in (*args, w, v)), chunk, sd)
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    y, state = ops.mamba_scan(*targs, chunk=chunk, return_state=True,
                              state_dtype=torch.bfloat16)
    ((y * torch.from_numpy(w)).sum()
     + (state * torch.from_numpy(v)).sum()).backward()
    t32 = [torch.from_numpy(a).requires_grad_() for a in args]
    y32, s32 = ops.mamba_scan(*t32, chunk=chunk, return_state=True)
    ((y32 * torch.from_numpy(w)).sum()
     + (s32 * torch.from_numpy(v)).sum()).backward()
    for i, name in enumerate(("u", "dt", "A", "B", "C")):
        d_ref = _hold(targs[i].grad, np.asarray(want["bfloat16"][i]),
                      np.asarray(want["float32"][i]), f"d{name}")
        _apart(targs[i].grad, t32[i].grad, d_ref, f"d{name}")
    # dD = sum dy u on the unrounded u: no state in it, fp32 in both
    assert rel_frobenius(targs[5].grad, np.asarray(want["bfloat16"][5])) \
        <= 1e-5


# -- the layer ----------------------------------------------------------------

# S = 16 over one chunk; 37 prime (the reference's chunk falls to 1); 24
# over chunks of 8; 2 shorter than d_conv - 1
@pytest.mark.parametrize("s,chunk", [(16, 256), (37, 8), (24, 8), (2, 256)])
def test_apply_mamba_matches_reference(s, chunk):
    cfg, tcfg, params, block = _pair(mamba_chunk=chunk, **BF16)
    cfg32 = dataclasses.replace(cfg, ssm_dtype="float32")
    x = _x(2, s, cfg.d_model)
    y16, c16 = jmamba.apply_mamba(params, jnp.asarray(x), cfg, REPLICATED,
                                  return_cache=True)
    y32, c32 = jmamba.apply_mamba(params, jnp.asarray(x), cfg32,
                                  REPLICATED, return_cache=True)
    ty, tcache = tmamba.apply_mamba(block, torch.from_numpy(x), tcfg,
                                    return_cache=True)
    d_y = _hold(ty, np.asarray(y16), np.asarray(y32), "layer output")
    d_s = _hold(tcache.state, np.asarray(c16.state, np.float32),
                np.asarray(c32.state), "cache state")
    assert tcache.state.shape == (2, cfg.d_inner, cfg.ssm_state)
    _bf16_values(tcache.state)
    np.testing.assert_array_equal(tcache.conv.numpy(), np.asarray(c16.conv))
    ty32, tc32 = tmamba.apply_mamba(
        block, torch.from_numpy(x), dataclasses.replace(tcfg,
                                                        ssm_dtype="float32"),
        return_cache=True)
    _apart(ty, ty32, d_y, "layer output")
    _apart(tcache.state, tc32.state, d_s, "cache state")


def test_decode_after_a_bf16_prefill():
    """Three decode steps (the fp32 recurrence in both packages) from the
    bf16 prefill's cache: each step's output and state held to the
    reference's bf16-prefilled and fp32-prefilled runs."""
    cfg, tcfg, params, block = _pair(seed=2, **BF16)
    cfg32 = dataclasses.replace(cfg, ssm_dtype="float32")
    x = _x(2, 16, cfg.d_model, seed=3)
    caches = {sd: jmamba.apply_mamba(params, jnp.asarray(x), c, REPLICATED,
                                     return_cache=True)[1]
              for sd, c in (("bf16", cfg), ("fp32", cfg32))}
    _, tcache = tmamba.apply_mamba(block, torch.from_numpy(x), tcfg,
                                   return_cache=True)
    for i, step in enumerate(_x(3, 2, cfg.d_model, seed=4)):
        xt = step[:, None, :]
        outs = {}
        for sd, c in (("bf16", cfg), ("fp32", cfg32)):
            outs[sd], caches[sd] = jmamba.decode_mamba(
                params, jnp.asarray(xt), caches[sd], c, REPLICATED)
        ty, tcache = tmamba.decode_mamba(block, torch.from_numpy(xt),
                                         tcache, tcfg)
        _hold(ty, np.asarray(outs["bf16"]), np.asarray(outs["fp32"]),
              f"decode step {i}")
        _hold(tcache.state, np.asarray(caches["bf16"].state, np.float32),
              np.asarray(caches["fp32"].state), f"decode state {i}")
        assert tcache.state.dtype == torch.float32


def test_bf16_configs_build():
    """``Mamba``, ``init_model`` and ``make_decode_state`` build a
    bf16-state config, its decode state fp32 as the reference's."""
    tcfg = tconfigs.reduced_config(ARCH, **BF16)
    block = tmamba.Mamba(tcfg, "cpu")
    assert block.A_log.dtype == torch.float32
    model = ttfm.init_model(tcfg, device="cpu")
    assert len(model.layers) == tcfg.n_layers
    state = ttfm.make_decode_state(tcfg, 2, 4, device="cpu")
    want = jtfm.make_decode_state(jconfigs.reduced_config(ARCH, **BF16), 2,
                                  4)
    for c in state.caches:
        assert c.state.dtype == torch.float32 and not c.state.any()
    assert {str(np.asarray(c.state).dtype)
            for c in want.caches.values()} == {"float32"}


# -- the models ---------------------------------------------------------------

def _models(case):
    arch, over = MODELS[case]
    cfg = jconfigs.reduced_config(arch, **over, **BF16)
    tcfg = tconfigs.reduced_config(arch, **over, **BF16)
    params = ref_lm_params(cfg)
    return cfg, tcfg, params


def _ref_run(params, cfg, tokens, forced):
    logits, state = jtfm.prefill(params, {"tokens": jnp.asarray(tokens)},
                                 cfg, REPLICATED, cache_len=16)
    out = [np.asarray(logits)]
    for tok in forced:
        logits, state = jtfm.decode_step(params, state, jnp.asarray(tok),
                                         cfg, REPLICATED)
        out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("case", sorted(MODELS))
def test_reduced_model_logits(case):
    """The prefill's last logits and two teacher-forced decode steps'."""
    cfg, tcfg, params = _models(case)
    cfg32 = dataclasses.replace(cfg, ssm_dtype="float32")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (2, 2)).astype(np.int32)
    ref16 = _ref_run(params, cfg, tokens, forced)
    ref32 = _ref_run(params, cfg32, tokens, forced)
    port = []
    for t32 in (False, True):
        c = dataclasses.replace(tcfg, ssm_dtype="float32") if t32 else tcfg
        model = convert.lm_params_to_port(params, c, device="cpu")
        logits, state = ttfm.prefill(
            model, {"tokens": torch.as_tensor(tokens, dtype=torch.int64)},
            c, cache_len=16)
        out = [logits.numpy()]
        for tok in forced:
            logits, state = ttfm.decode_step(
                model, state, torch.as_tensor(tok, dtype=torch.int64), c)
            out.append(logits.numpy())
        port.append(out)
    n = cfg.vocab_size
    for i, (got, w16, w32, got32) in enumerate(zip(port[0], ref16, ref32,
                                                   port[1])):
        what = "prefill" if i == 0 else f"decode step {i}"
        d_ref = _hold(got[..., :n], w16[..., :n], w32[..., :n], what)
        _apart(got[..., :n], got32[..., :n], d_ref, what)


@pytest.mark.parametrize("case", sorted(MODELS))
def test_gradients_against_jax(case):
    """Every parameter's gradient against ``jax.value_and_grad`` of the
    reference's ``loss_fn``, bf16 state.  (The scalar loss is no such
    quantity: the mean over tokens averages the noise out, and what is
    left is a sequential scan's bias against an associative one's.)"""
    cfg, tcfg, params = _models(case)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    want = {}
    for sd in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, ssm_dtype=sd)
        (loss, _), grads = jax.value_and_grad(
            lambda p: jtfm.loss_fn(p, {"tokens": jnp.asarray(tokens)}, c,
                                   REPLICATED), has_aux=True)(params)
        want[sd] = (float(loss), convert.lm_state_dict(
            jax.tree.map(np.asarray, grads), tcfg))
    got = {}
    for sd in ("bfloat16", "float32"):
        c = dataclasses.replace(tcfg, ssm_dtype=sd)
        model = convert.lm_params_to_port(params, c,
                                          device="cpu").requires_grad_(True)
        loss, _ = ttfm.loss_fn(
            model, {"tokens": torch.as_tensor(tokens, dtype=torch.int64)}, c)
        loss.backward()
        got[sd] = (float(loss.detach()), {k: p.grad for k, p in
                                          model.named_parameters()})
    g16, w16, w32 = got["bfloat16"][1], want["bfloat16"][1], \
        want["float32"][1]
    assert set(g16) == set(w16)
    total = np.sqrt(sum(float(np.sum(np.square(w, dtype=np.float64)))
                        for w in w32.values()))
    for k in w16:
        if np.linalg.norm(w32[k]) <= 1e-6 * total:
            # zero in exact arithmetic (no path from the loss): rounding
            # residue in both packages
            assert g16[k] is None or float(torch.linalg.norm(
                g16[k])) <= 1e-6 * total, k
            continue
        d_ref = _hold(g16[k], w16[k], w32[k], k)
        _apart(g16[k], got["float32"][1][k], d_ref, k)
