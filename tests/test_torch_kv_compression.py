"""The port's KV-cache PCA compression (``repro_torch.models.kv_compression``)
against the reference's, on the CPU.

The first three tests are ``tests/test_kv_compression.py`` case by case on
the port (its full rank sweep, marked slow there, runs here at the same
ranks: the port's CPU solve takes well under a second).  Then parity on
the same caches: ``attention_error``, ``suggest_rank``, the per-head
eigenvalues and the bases, compared as projectors B B^T (each
eigenvector's sign is free).  The port forms each head's Gram with the
``covariance`` op and solves with the fused sweep (on the CPU its plain
round loop); the reference uses an einsum and the unfused loop, so they
agree to fp32 rounding: eigenvalues to relative Frobenius 1e-5,
projectors of a rank with a clear spectral gap to 1e-4, errors to 1e-4
(relative) and ranks exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import kv_compression as jkvc
from repro_torch.models import kv_compression as kvc

from _torch_parity import rel_frobenius, to_numpy


def _lowrank_cache(b, s, kv, hd, r_true, seed=0, noise=0.0):
    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((kv, hd, r_true)).astype(np.float32)
    coef = rng.standard_normal((b, s, kv, r_true)).astype(np.float32)
    x = np.einsum("bskr,kdr->bskd", coef, basis)
    if noise:
        x = x + noise * rng.standard_normal(x.shape).astype(np.float32)
    return x.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- tests/test_kv_compression.py on the port -----------------------------------

def test_exact_for_truly_lowrank_cache():
    k = _lowrank_cache(2, 64, 4, 32, r_true=6, seed=1)
    v = _lowrank_cache(2, 64, 4, 32, r_true=6, seed=2)
    q = np.random.default_rng(3).standard_normal((2, 4, 2, 32)).astype(
        np.float32)
    err, ratio = kvc.attention_error(_t(q), _t(k), _t(v),
                                     kvc.KVCompressionConfig(rank=8), 0.18)
    assert float(err) < 1e-3
    assert ratio == 8 / 32


def _rank_sweep_errs(ranks):
    k = _lowrank_cache(1, 96, 2, 32, r_true=12, seed=4, noise=0.05)
    v = _lowrank_cache(1, 96, 2, 32, r_true=12, seed=5, noise=0.05)
    q = np.random.default_rng(6).standard_normal((1, 2, 3, 32)).astype(
        np.float32)
    errs = []
    for r in ranks:
        e, _ = kvc.attention_error(_t(q), _t(k), _t(v),
                                   kvc.KVCompressionConfig(rank=r), 0.18)
        errs.append(float(e))
    assert errs[-1] < 1e-3              # full rank = exact
    assert all(b <= a + 1e-6 for a, b in zip(errs, errs[1:]))
    return errs


@pytest.mark.parametrize("ranks", [(2, 32), (2, 8, 16, 32)],
                         ids=["fast", "full"])
def test_error_decreases_with_rank(ranks):
    _rank_sweep_errs(ranks)


def test_suggest_rank_finds_true_rank():
    k = _lowrank_cache(2, 128, 3, 32, r_true=5, seed=7)
    r = kvc.suggest_rank(_t(k), coverage=0.999)
    assert 4 <= r <= 7


# -- parity with the reference ------------------------------------------------

# ranks at a spectral gap (the cache has rank 12 plus noise) and full rank;
# a rank inside the noise floor's cluster of near-equal eigenvalues (13
# to 31) keeps an arbitrary basis of that cluster in either package
@pytest.mark.parametrize("rank", [2, 8, 12, 32])
def test_attention_error_matches_reference(rank):
    k = _lowrank_cache(1, 96, 2, 32, r_true=12, seed=4, noise=0.05)
    v = _lowrank_cache(1, 96, 2, 32, r_true=12, seed=5, noise=0.05)
    q = np.random.default_rng(6).standard_normal((1, 2, 3, 32)).astype(
        np.float32)
    cfg_j = jkvc.KVCompressionConfig(rank=rank)
    cfg_t = kvc.KVCompressionConfig(rank=rank)
    want, wr = jkvc.attention_error(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), cfg_j, 0.18)
    got, gr = kvc.attention_error(_t(q), _t(k), _t(v), cfg_t, 0.18)
    assert gr == wr
    if rank < 32:
        assert abs(float(got) - float(want)) <= 1e-4 * float(want)
    else:  # full rank: both at rounding level
        assert float(got) < 1e-5 and float(want) < 1e-5


@pytest.mark.parametrize("coverage", [0.9, 0.99, 0.999])
def test_suggest_rank_matches_reference(coverage):
    k = _lowrank_cache(2, 128, 3, 32, r_true=5, seed=7, noise=0.02)
    assert kvc.suggest_rank(_t(k), coverage=coverage) == \
        jkvc.suggest_rank(jnp.asarray(k), coverage=coverage)


@pytest.mark.parametrize("hd,rank", [(32, 8), (16, 4), (64, 12)])
def test_eigenvalues_and_bases_match_reference(hd, rank):
    x = _lowrank_cache(2, 80, 3, hd, r_true=rank + 4, seed=hd, noise=0.05)
    bj, ej = jkvc._per_head_basis(jnp.asarray(x), rank, 12)
    bt, et = kvc._per_head_basis(_t(x), rank, 12)
    assert tuple(bt.shape) == tuple(bj.shape) == (3, hd, rank)
    assert rel_frobenius(et, ej) <= 1e-5
    ej = np.asarray(ej)
    assert (ej[:, rank - 1] - ej[:, rank] > 1e-2 * ej[:, 0]).all()  # a gap
    pj = np.einsum("kdr,ker->kde", np.asarray(bj), np.asarray(bj))
    pt = np.einsum("kdr,ker->kde", to_numpy(bt), to_numpy(bt))
    assert rel_frobenius(pt, pj) <= 1e-4


def test_compress_decompress_match_reference():
    k = _lowrank_cache(2, 40, 2, 16, r_true=6, seed=11, noise=0.01)
    v = _lowrank_cache(2, 40, 2, 16, r_true=6, seed=12, noise=0.01)
    cj = jkvc.compress(jnp.asarray(k), jnp.asarray(v),
                       jkvc.KVCompressionConfig(rank=6))
    ct = kvc.compress(_t(k), _t(v), kvc.KVCompressionConfig(rank=6))
    assert tuple(ct.k.shape) == tuple(cj.k.shape) == (2, 40, 2, 6)
    for got, want in zip(kvc.decompress(ct), jkvc.decompress(cj)):
        # the reconstruction is sign-free: held to the reference's
        assert rel_frobenius(got, want) <= 1e-4
    q = np.random.default_rng(13).standard_normal((2, 2, 3, 16)).astype(
        np.float32)
    assert rel_frobenius(kvc.attention_compressed(_t(q), ct, 0.25),
                         jkvc.attention_compressed(jnp.asarray(q), cj,
                                                   0.25)) <= 1e-4
    assert rel_frobenius(kvc.attention_exact(_t(q), _t(k), _t(v), 0.25),
                         jkvc.attention_exact(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v), 0.25)) <= 1e-5


def test_head_major_cache_view_gives_the_same_result():
    """The port's own cache is (B, KV, S, hd); its (B, S, KV, hd) view
    gives the same bases as a contiguous copy."""
    x = _lowrank_cache(2, 48, 2, 16, r_true=5, seed=21, noise=0.02)
    head_major = _t(x).transpose(1, 2).contiguous()
    b_view, e_view = kvc._per_head_basis(head_major.transpose(1, 2), 5, 12)
    b_copy, e_copy = kvc._per_head_basis(_t(x), 5, 12)
    np.testing.assert_array_equal(to_numpy(e_view), to_numpy(e_copy))
    np.testing.assert_array_equal(to_numpy(b_view), to_numpy(b_copy))
