"""The port's optimizer-side PCA consumers (``repro_torch.optim.spectral``,
``repro_torch.optim.compression``) against the reference's, on the CPU.

The reference's own tests of both (``tests/test_substrate.py``) run on the
port first, then parity:

* ``gradient_spectrum`` with n <= ``probe_dim`` (no sketch) and with the
  reference's sketch passed in, and ``tree_spectra`` with the reference's
  per-parameter sketches (``fold_in(key, i)`` in its flattening order):
  eigenvalues, EVCR, CVCR and effective rank to relative 1e-5 (fp32
  Grams summed in other orders, the same Jacobi rounds);
* ``compress_tree`` over 3 steps from the reference's ``init_state``
  carried across (its subspaces are seeded with Python's salted
  ``hash``, so they are not redrawn), error feedback on and off: the
  compressed gradients, the subspaces and the error buffers to relative
  1e-4 (each step's orthonormalisation divides by the square roots of
  small eigenvalues, which amplifies rounding; the first step measured
  1e-6).  The gradients there are full rank: from the second step P =
  G G^T P_prev has condition number (s_1 / s_r)^4, and where that passes
  fp32's 1e7 (a rank-3 gradient compressed at rank 4) the smallest
  eigenvalue of P^T P is rounding noise in both packages, clamped to
  1e-12, and each package's P is its own arbitrary blow-up.

Trees: the reference's ``{"w": ...}`` is the port's ``{"w": ...}``; its
key string ``"['w']"`` (``keystr``) names the port's ``"w"``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as jcomp
from repro.optim import spectral as jspectral
from repro_torch.optim import compression as comp
from repro_torch.optim import spectral

from _torch_parity import rel_frobenius, to_numpy


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _grads(seed=5):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((512, 3)).astype(np.float32)
    v = rng.standard_normal((3, 256)).astype(np.float32)
    return {"w_lowrank": (u @ v).astype(np.float32),
            "w_fullrank": rng.standard_normal((512, 256)).astype(np.float32),
            "w_stacked": rng.standard_normal((2, 64, 24)).astype(np.float32),
            "b": rng.standard_normal((256,)).astype(np.float32)}


# -- tests/test_substrate.py on the port ------------------------------------------

def test_spectral_telemetry_detects_low_rank():
    g = _grads()
    grads = {"w_lowrank": _t(g["w_lowrank"]), "w_fullrank": _t(g["w_fullrank"])}
    cfg = spectral.SpectralConfig(probe_dim=16, min_size=1)
    spectra = spectral.tree_spectra(grads, cfg)
    eff_low = float(spectra["w_lowrank"]["effective_rank"])
    eff_full = float(spectra["w_fullrank"]["effective_rank"])
    assert eff_low < 4.0 < eff_full
    r = spectral.suggest_compression_rank(
        {"w": spectra["w_lowrank"]}, coverage=0.95)
    assert 1 <= r <= 4


def test_compression_low_rank_exact_for_low_rank_grad():
    cfg = comp.CompressionConfig(rank=4, min_size=1)
    rng = np.random.default_rng(2)
    u = rng.standard_normal((64, 4)).astype(np.float32)
    v = rng.standard_normal((4, 32)).astype(np.float32)
    g = {"w": _t(u @ v)}
    state = comp.init_state(g, cfg, torch.Generator().manual_seed(0))
    out, state, _ = comp.compress_tree(g, state, cfg)
    assert rel_frobenius(out["w"], g["w"]) < 1e-2


def test_compression_error_feedback_recovers_signal():
    cfg = comp.CompressionConfig(rank=1, min_size=1)
    rng = np.random.default_rng(3)
    g_true = _t(rng.standard_normal((32, 16)).astype(np.float32))
    state = comp.init_state({"w": g_true}, cfg,
                            torch.Generator().manual_seed(1))
    acc = torch.zeros_like(g_true)
    rels = []
    for i in range(30):
        out, state, _ = comp.compress_tree({"w": g_true}, state, cfg)
        acc = acc + out["w"]
        rels.append(rel_frobenius(acc / (i + 1), g_true))
    assert rels[-1] < 0.5
    assert rels[-1] < 0.6 * rels[0]
    assert rels[-1] < rels[9] < rels[0]


def test_compression_small_params_exact():
    cfg = comp.CompressionConfig(rank=2, min_size=10_000)
    g = {"b": torch.ones(8), "w": torch.ones(4, 4)}
    state = comp.init_state(g, cfg)
    out, _, m = comp.compress_tree(g, state, cfg)
    np.testing.assert_array_equal(out["b"].numpy(), np.ones((8,)))
    np.testing.assert_array_equal(out["w"].numpy(), np.ones((4, 4)))
    assert m == {"compressed_bytes": 0, "exact_bytes": (8 + 16) * 4}


# -- spectral parity ------------------------------------------------------------

def _assert_spectrum(got, want, tol=1e-5):
    for g, w in zip(got, want):
        assert rel_frobenius(g, w) <= tol


@pytest.mark.parametrize("shape", [(200, 24), (64, 32), (3, 40, 17)])
def test_gradient_spectrum_without_sketch(shape):
    g = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    cfg_j = jspectral.SpectralConfig(probe_dim=48)
    cfg_t = spectral.SpectralConfig(probe_dim=48)
    _assert_spectrum(spectral.gradient_spectrum(_t(g), cfg_t),
                     jspectral.gradient_spectrum(jnp.asarray(g), cfg_j))


@pytest.mark.parametrize("probe", [8, 16, 32])
def test_gradient_spectrum_with_the_reference_sketch(probe):
    g = _grads()["w_fullrank"]
    key = jax.random.PRNGKey(probe)
    n = g.shape[1]
    sketch = jax.random.normal(key, (n, probe), jnp.float32) / jnp.sqrt(n)
    want = jspectral.gradient_spectrum(
        jnp.asarray(g), jspectral.SpectralConfig(probe_dim=probe), key)
    got = spectral.gradient_spectrum(
        _t(g), spectral.SpectralConfig(probe_dim=probe), sketch=_t(sketch))
    _assert_spectrum(got, want)


def test_gradient_spectrum_draws_its_own_sketch():
    g = _t(_grads()["w_fullrank"])
    cfg = spectral.SpectralConfig(probe_dim=16)
    a = spectral.gradient_spectrum(g, cfg, torch.Generator().manual_seed(3))
    b = spectral.gradient_spectrum(g, cfg, torch.Generator().manual_seed(3))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert a[0].shape == (16,) and float(a[2][-1]) == pytest.approx(1.0)


def test_tree_spectra_with_the_reference_sketches():
    g = _grads()
    cfg_j = jspectral.SpectralConfig(probe_dim=16, min_size=1000)
    cfg_t = spectral.SpectralConfig(probe_dim=16, min_size=1000)
    key = jax.random.PRNGKey(9)
    want = jspectral.tree_spectra({k: jnp.asarray(v) for k, v in g.items()},
                                  cfg_j, key)
    # the reference's sketch of leaf i (sorted key order) is fold_in(key, i)
    sketches = {}
    for i, name in enumerate(sorted(g)):
        n = g[name].shape[-1]
        if n > 16:
            sketches[name] = _t(jax.random.normal(
                jax.random.fold_in(key, i), (n, 16), jnp.float32)
                / jnp.sqrt(n))
    got = spectral.tree_spectra({k: _t(v) for k, v in g.items()}, cfg_t,
                                sketches=sketches)
    assert sorted(got) == sorted(k.strip("[]'") for k in want)
    for name, spec in got.items():
        ref = want[f"['{name}']"]
        for field in ("eigenvalues", "evcr", "cvcr", "effective_rank"):
            assert rel_frobenius(spec[field], ref[field]) <= 1e-5, field
    for cov in (0.5, 0.9, 0.99):
        assert spectral.suggest_compression_rank(got, cov) == \
            jspectral.suggest_compression_rank(want, cov)
    assert spectral.suggest_compression_rank({}) == 0


# -- compression parity -----------------------------------------------------------

@pytest.mark.parametrize("error_feedback", [True, False])
def test_compress_tree_three_steps_from_the_reference_state(error_feedback):
    rng = np.random.default_rng(8)
    g = {"w": rng.standard_normal((96, 64)).astype(np.float32),
         "w_stacked": rng.standard_normal((2, 64, 40)).astype(np.float32),
         "b": rng.standard_normal((64,)).astype(np.float32)}
    cfg_j = jcomp.CompressionConfig(rank=4, min_size=1000,
                                    error_feedback=error_feedback)
    cfg_t = comp.CompressionConfig(rank=4, min_size=1000,
                                   error_feedback=error_feedback)
    jgrads = {k: jnp.asarray(v) for k, v in g.items()}
    jstate = jcomp.init_state(jgrads, cfg_j, jax.random.PRNGKey(0))

    def carried(tree):  # reference keys ("['w']",) -> port keys "w"
        return {k[0].strip("[]'"): None if v is None else _t(v)
                for k, v in tree.items()}

    tstate = comp.CompressionState(q=carried(jstate.q),
                                   error=carried(jstate.error))
    assert sorted(k for k, v in tstate.q.items() if v is not None) == \
        ["w", "w_stacked"]
    rng = np.random.default_rng(10)
    for step in range(3):
        noise = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
                 for k, v in g.items()}
        step_g = {k: v + noise[k] for k, v in g.items()}
        jout, jstate, jm = jcomp.compress_tree(
            {k: jnp.asarray(v) for k, v in step_g.items()}, jstate, cfg_j)
        tout, tstate, tm = comp.compress_tree(
            {k: _t(v) for k, v in step_g.items()}, tstate, cfg_t)
        assert tm == jm
        for name in g:
            assert rel_frobenius(tout[name], jout[name]) <= 1e-4, (step, name)
            jq = jstate.q[(f"['{name}']",)]
            if jq is None:
                assert tstate.q[name] is None
                continue
            assert rel_frobenius(tstate.q[name], jq) <= 1e-4, (step, name)
            je = np.asarray(jstate.error[(f"['{name}']",)])
            te = to_numpy(tstate.error[name])
            if error_feedback:
                assert rel_frobenius(te, je) <= 1e-4, (step, name)
            else:
                assert not te.any() and not je.any()


def test_orthonormalize_matches_reference():
    p = np.random.default_rng(12).standard_normal((300, 6)).astype(np.float32)
    got = comp._orthonormalize(_t(p), 8)
    want = jcomp._orthonormalize(jnp.asarray(p), 8)
    assert rel_frobenius(got, want) <= 1e-5
    np.testing.assert_allclose(to_numpy(got.T @ got), np.eye(6), atol=1e-5)


def test_init_state_is_seeded_and_skips_small_params():
    params = {k: _t(v) for k, v in _grads().items()}
    cfg = comp.CompressionConfig(rank=3, min_size=1000)
    a = comp.init_state(params, cfg, torch.Generator().manual_seed(4))
    b = comp.init_state(params, cfg, torch.Generator().manual_seed(4))
    assert a.q["b"] is None and a.error["b"] is None
    assert a.q["w_stacked"].shape == (24, 3)
    assert a.error["w_stacked"].shape == (2, 64, 24)
    for k in ("w_lowrank", "w_fullrank", "w_stacked"):
        np.testing.assert_array_equal(a.q[k].numpy(), b.q[k].numpy())


def test_axis_name_without_a_mesh_raises():
    g = {"w": torch.ones(64, 32)}
    cfg = comp.CompressionConfig(rank=2, min_size=1, axis_name="pod")
    state = comp.init_state(g, cfg)
    with pytest.raises(ValueError, match="axis_name='pod' needs a "
                       "parallel.Mesh with that axis; got no mesh"):
        comp.compress_tree(g, state, cfg)


def test_arrays_go_to_the_device_asked_for():
    """numpy input goes to ``device`` (default ``cuda``, which raises on a
    host without a card); a tensor stays where it is."""
    from repro_torch.models import kv_compression as kvc
    rng = np.random.default_rng(14)
    g = rng.standard_normal((300, 48))                   # float64 numpy
    cfg = spectral.SpectralConfig(probe_dim=16)
    sketch = _t((rng.standard_normal((48, 16)) / 48 ** 0.5).astype(
        np.float32))
    a = spectral.gradient_spectrum(g, cfg, sketch=sketch, device="cpu")
    b = spectral.gradient_spectrum(_t(g.astype(np.float32)), cfg,
                                   sketch=sketch)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    ccfg = comp.CompressionConfig(rank=2, min_size=1)
    state = comp.init_state({"w": g}, ccfg, device="cpu")
    out, _, _ = comp.compress_tree({"w": g}, state, ccfg, device="cpu")
    assert out["w"].dtype == torch.float32 and out["w"].device.type == "cpu"
    k = rng.standard_normal((1, 32, 2, 8))
    assert 1 <= kvc.suggest_rank(k, device="cpu") <= 8
    if torch.cuda.is_available():
        return  # the default device works on this host
    for call in (lambda: spectral.gradient_spectrum(g, cfg),
                 lambda: comp.init_state({"w": g}, ccfg),
                 lambda: kvc.suggest_rank(k)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
