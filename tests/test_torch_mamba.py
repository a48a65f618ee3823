"""The port's Mamba block (``repro_torch.models.mamba``) against the
reference's (``repro.models.mamba``) on the CPU, at reduced falcon-mamba
(d 64, d_inner 128, N 8, d_conv 4, fp32).

The reference's ``init_mamba`` values are carried into the port's
``Mamba`` (``A_log``, ``D``, ``dt_b`` and ``conv_b`` redrawn so that they
are not the structured init) and the same seeded input goes through
``apply_mamba`` (prefill: y, the conv cache, the final state) and
``decode_mamba``.  Tolerances: relative Frobenius ``TOL`` = 1e-5 for y
and the state (both fp32; the reference scans with an associative scan
in chunks, the port's op step by step, so the sums run in other orders;
measured about 3e-7); exact for the prefill's conv cache (the raw
inputs of the last d_conv - 1 steps: one matmul of one shape in both
measured bitwise equal) and for a decode step's shift of that window;
the input a decode step appends (a one-token matmul) within ``TOL``.
"""
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
from repro_torch.kernels import mamba_scan as kscan
from repro_torch.kernels import ops, ref
from repro_torch.models import mamba as tmamba
from repro_torch.models import transformer as ttfm

from _torch_parity import rel_frobenius

TOL = 1e-5
ARCH = "falcon-mamba-7b"


def _pair(seed: int = 0, **overrides):
    """(reference cfg, port cfg, reference params as numpy, port Mamba)
    holding the same values."""
    cfg = jconfigs.reduced_config(ARCH, **overrides)
    tcfg = tconfigs.reduced_config(ARCH, **overrides)
    params = jax.tree.map(np.asarray, jtfm.param_values(
        jmamba.init_mamba(jax.random.PRNGKey(seed), cfg)))
    rng = np.random.default_rng(seed + 50)
    params["A_log"] = np.log(rng.uniform(0.5, 8.0, params["A_log"].shape)
                             ).astype(np.float32)
    params["D"] = rng.standard_normal(params["D"].shape).astype(np.float32)
    params["dt_b"] = (params["dt_b"] + 0.5 * rng.standard_normal(
        params["dt_b"].shape)).astype(np.float32)
    params["conv_b"] = (0.1 * rng.standard_normal(
        params["conv_b"].shape)).astype(np.float32)
    block = tmamba.Mamba(tcfg, "cpu")
    block.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in params.items()}, strict=True)
    return cfg, tcfg, params, block


def _x(b: int, s: int, d: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


# S = 16: one reference chunk; 37: prime, so the reference's chunk shrinks
# to 1 (no length is a multiple of its chunk); 2: shorter than d_conv - 1,
# the conv cache zero-padded in front
@pytest.mark.parametrize("s,chunk", [(16, 256), (37, 8), (24, 8), (2, 256)])
def test_prefill_matches_reference(s, chunk):
    cfg, tcfg, params, block = _pair(mamba_chunk=chunk)
    x = _x(2, s, cfg.d_model)
    y, cache = jmamba.apply_mamba(params, jnp.asarray(x), cfg, REPLICATED,
                                  return_cache=True)
    ty, tcache = tmamba.apply_mamba(block, torch.from_numpy(x), tcfg,
                                    return_cache=True)
    assert ty.shape == (2, s, cfg.d_model) and ty.dtype == torch.float32
    assert rel_frobenius(ty.numpy(), np.asarray(y)) <= TOL
    assert tcache.state.shape == (2, cfg.d_inner, cfg.ssm_state)
    assert tcache.state.dtype == torch.float32
    assert rel_frobenius(tcache.state.numpy(), np.asarray(cache.state)) <= TOL
    assert tcache.conv.shape == (2, cfg.d_conv - 1, cfg.d_inner)
    np.testing.assert_array_equal(tcache.conv.numpy(), np.asarray(cache.conv))
    if s < cfg.d_conv - 1:  # the zero padding in front of the prompt
        assert not tcache.conv[:, :cfg.d_conv - 1 - s].any()


def test_prefill_without_cache():
    cfg, tcfg, params, block = _pair()
    x = _x(1, 9, cfg.d_model)
    y, none = jmamba.apply_mamba(params, jnp.asarray(x), cfg, REPLICATED)
    ty, tnone = tmamba.apply_mamba(block, torch.from_numpy(x), tcfg)
    assert none is None and tnone is None
    assert rel_frobenius(ty.numpy(), np.asarray(y)) <= TOL


@pytest.mark.parametrize("s", [2, 16])
def test_decode_matches_reference(s):
    """Three decode steps after the prefill, each step's y and the whole
    cache against the reference's."""
    cfg, tcfg, params, block = _pair(seed=2)
    x = _x(2, s, cfg.d_model, seed=3)
    _, cache = jmamba.apply_mamba(params, jnp.asarray(x), cfg, REPLICATED,
                                  return_cache=True)
    _, tcache = tmamba.apply_mamba(block, torch.from_numpy(x), tcfg,
                                   return_cache=True)
    steps = _x(3, 2, cfg.d_model, seed=4)
    for step in steps:
        xt = step[:, None, :]
        before = tcache.conv
        y, cache = jmamba.decode_mamba(params, jnp.asarray(xt), cache, cfg,
                                       REPLICATED)
        ty, tcache = tmamba.decode_mamba(block, torch.from_numpy(xt),
                                         tcache, tcfg)
        assert ty.shape == (2, 1, cfg.d_model)
        assert rel_frobenius(ty.numpy(), np.asarray(y)) <= TOL
        assert rel_frobenius(tcache.state.numpy(),
                             np.asarray(cache.state)) <= TOL
        # the window shifts by one input, exactly; the new input is one
        # token's projection (a matmul of another shape than the
        # prefill's, summed in another order than XLA's): within TOL
        np.testing.assert_array_equal(tcache.conv[:, :-1].numpy(),
                                      before[:, 1:].numpy())
        assert rel_frobenius(tcache.conv[:, -1].numpy(),
                             np.asarray(cache.conv)[:, -1]) <= TOL


def test_prefill_then_decode_equals_a_longer_prefill():
    """The decode recurrence continues the scan's final state: S - 1
    prefilled tokens and one decode step give the S-token prefill's last
    output and state."""
    _, tcfg, _, block = _pair(seed=5)
    x = torch.from_numpy(_x(2, 12, tcfg.d_model, seed=6))
    y_full, c_full = tmamba.apply_mamba(block, x, tcfg, return_cache=True)
    _, c = tmamba.apply_mamba(block, x[:, :-1], tcfg, return_cache=True)
    y_last, c_last = tmamba.decode_mamba(block, x[:, -1:], c, tcfg)
    assert rel_frobenius(y_last.numpy(), y_full[:, -1:].numpy()) <= TOL
    assert rel_frobenius(c_last.state.numpy(), c_full.state.numpy()) <= TOL
    np.testing.assert_array_equal(c_last.conv[:, :-1].numpy(),
                                  c_full.conv[:, :-1].numpy())
    assert rel_frobenius(c_last.conv.numpy(), c_full.conv.numpy()) <= TOL


def test_init_cache_and_params_match_reference():
    cfg = jconfigs.reduced_config(ARCH)
    tcfg = tconfigs.reduced_config(ARCH)
    want = jmamba.init_mamba_cache(cfg, 3, jnp.float32)
    got = tmamba.init_mamba_cache(tcfg, 3, torch.float32, "cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and not g.any()
    assert got.state.dtype == torch.float32
    params = jax.tree.map(np.asarray, jtfm.param_values(
        jmamba.init_mamba(jax.random.PRNGKey(0), cfg)))
    block = tmamba.Mamba(tcfg, "cpu")
    with torch.no_grad():
        block.reset_parameters(torch.Generator().manual_seed(0))
    for name, t in block.state_dict().items():
        assert tuple(t.shape) == params[name].shape, name
        assert str(t.dtype).split(".")[1] == params[name].dtype.name, name
    # the structured leaves are the reference's exactly
    for name in ("conv_b", "D", "dt_b"):
        np.testing.assert_array_equal(block.state_dict()[name].numpy(),
                                      params[name])
    # log(1..N): the two libraries' fp32 log differ by up to one ulp
    np.testing.assert_allclose(block.A_log.numpy(), params["A_log"],
                               rtol=2.0 ** -23, atol=0)


def _numpy_scan(u, dt, A, B, C, D):
    """The selective scan one step at a time in float64."""
    b, L, d = u.shape
    x = np.zeros((b, d, A.shape[1]))
    ys = np.zeros((b, L, d))
    for t in range(L):
        x = (np.exp(dt[:, t, :, None] * A[None]) * x
             + (dt[:, t] * u[:, t])[..., None] * B[:, t, None, :])
        ys[:, t] = (x * C[:, t, None, :]).sum(-1) + D * u[:, t]
    return ys, x


@pytest.mark.parametrize("shape", [(2, 19, 12, 8), (1, 5, 3, 16),
                                   (3, 1, 4, 1)])
def test_scan_op_return_state_against_a_numpy_loop(shape):
    b, L, d, n = shape
    rng = np.random.default_rng(7)
    args = (rng.standard_normal((b, L, d)),
            rng.uniform(0.01, 0.2, (b, L, d)),
            -rng.uniform(0.5, 2.0, (d, n)),
            rng.standard_normal((b, L, n)), rng.standard_normal((b, L, n)),
            rng.standard_normal(d))
    want_y, want_x = _numpy_scan(*args)
    targs = [torch.from_numpy(a.astype(np.float32)) for a in args]
    for fn in (lambda *a, **k: ops.mamba_scan(*a, **k),
               lambda *a, **k: ops.mamba_scan(*a, backend="torch", **k),
               ref.mamba_scan, kscan.mamba_scan):
        y, state = fn(*targs, return_state=True)
        assert state.shape == (b, d, n) and state.dtype == torch.float32
        assert rel_frobenius(y.numpy(), want_y) <= TOL
        assert rel_frobenius(state.numpy(), want_x) <= TOL
        # the default call is y alone, the same values
        torch.testing.assert_close(fn(*targs), y, rtol=0, atol=0)


def test_scan_op_return_state_of_an_empty_sequence():
    u = torch.zeros(2, 0, 3)
    y, state = ops.mamba_scan(u, u, torch.ones(3, 4), torch.zeros(2, 0, 4),
                              torch.zeros(2, 0, 4), torch.ones(3),
                              return_state=True)
    assert y.shape == (2, 0, 3) and state.shape == (2, 3, 4)
    assert not state.any()


# ssm_dtype takes "float32" and "bfloat16" (tests/test_torch_mamba_bf16.py);
# any other value raises a KeyError in both packages: the reference's
# apply_mamba looks the dtype up, the port's Mamba, apply_mamba,
# init_model and make_decode_state too
@pytest.mark.parametrize("package", ["reference", "port"])
@pytest.mark.parametrize("ssm_dtype", ["float16", "float64"])
def test_unknown_ssm_dtype_raises(package, ssm_dtype):
    cfg, tcfg, params, block = _pair()
    x = _x(1, 3, cfg.d_model)
    bad = {"ssm_dtype": ssm_dtype}
    if package == "reference":
        with pytest.raises(KeyError):
            jmamba.apply_mamba(params, jnp.asarray(x),
                               jconfigs.reduced_config(ARCH, **bad),
                               REPLICATED)
        return
    tbad = tconfigs.reduced_config(ARCH, **bad)
    with pytest.raises(KeyError):
        tmamba.Mamba(tbad, "cpu")
    with pytest.raises(KeyError):
        ttfm.init_model(tbad, device="cpu")
    with pytest.raises(KeyError):
        ttfm.make_decode_state(tbad, 1, 4, device="cpu")
    # a block built under the default options refuses the call too
    with pytest.raises(KeyError):
        tmamba.apply_mamba(block, torch.from_numpy(x), tbad)


# ssm_impl="kernel_proxy": the reference's dry-run stand-in for the scan
# kernel's memory traffic (y = u dt (B . C) + D u, a zero final state)
@pytest.mark.parametrize("s", [16, 37])
def test_kernel_proxy_prefill_matches_reference(s):
    cfg, tcfg, params, block = _pair(ssm_impl="kernel_proxy")
    x = _x(2, s, cfg.d_model, seed=7)
    y, _ = jmamba.apply_mamba(params, jnp.asarray(x), cfg, REPLICATED)
    ty, none = tmamba.apply_mamba(block, torch.from_numpy(x), tcfg)
    assert none is None
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=1e-5,
                               atol=1e-5)


def test_kernel_proxy_cache_matches_reference():
    """The cache: the conv inputs as the scan path keeps them, and the
    reference's zero state; a decode step from it, the plain recurrence
    in both."""
    cfg, tcfg, params, block = _pair(ssm_impl="kernel_proxy")
    x = _x(2, 9, cfg.d_model, seed=8)
    _, cache = jmamba.apply_mamba(params, jnp.asarray(x), cfg, REPLICATED,
                                  return_cache=True)
    _, tcache = tmamba.apply_mamba(block, torch.from_numpy(x), tcfg,
                                   return_cache=True)
    assert tcache.state.shape == (2, cfg.d_inner, cfg.ssm_state)
    assert tcache.state.dtype == torch.float32 and not tcache.state.any()
    np.testing.assert_array_equal(np.asarray(cache.state), 0)
    np.testing.assert_array_equal(tcache.conv.numpy(), np.asarray(cache.conv))
    xt = _x(2, 1, cfg.d_model, seed=9)
    y, cache = jmamba.decode_mamba(params, jnp.asarray(xt), cache, cfg,
                                   REPLICATED)
    ty, tcache = tmamba.decode_mamba(block, torch.from_numpy(xt), tcache,
                                     tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tcache.state.numpy(), np.asarray(cache.state),
                               rtol=1e-5, atol=1e-5)


def test_kernel_proxy_launches_no_scan():
    """The proxy calls no scan: neither the op nor a kernel runs."""
    from repro_torch.backends import registry
    _, tcfg, _, block = _pair(ssm_impl="kernel_proxy")
    registry.reset_resolution_counts()
    tmamba.apply_mamba(block, torch.zeros(1, 5, tcfg.d_model), tcfg)
    assert ("mamba_scan", "torch") not in registry.resolution_counts()
