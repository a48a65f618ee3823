"""The port's Mixture-of-Experts layer (``repro_torch.models.moe``)
against the reference's single-shard path (``repro.models.moe``) on the
CPU, at reduced widths (d 64, d_ff 128, 4 experts, fp32), the layer and
its drops also at arctic's and llama4's published 128 experts.

The reference's ``init_moe`` (and ``init_mlp`` for arctic's dense
residual and llama4's shared expert) values are carried into the port's
modules and the same seeded tokens go through both.  Tolerances:
``capacity`` and the routed expert ids exact (integers); gates, ``aux``
and outputs relative Frobenius ``TOL`` = 1e-5 (fp32; XLA and torch sum
the router and expert matmuls in other orders; measured about 1e-7).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.parallel.sharding import REPLICATED
from repro_torch import configs as tconfigs
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe

from _torch_parity import rel_frobenius

TOL = 1e-5


def _values(tree):
    return jax.tree.map(np.asarray, jtfm.param_values(tree))


def _load(module, params):
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in params.items()}, strict=True)
    return module


def _pair(arch: str, seed: int = 0, **overrides):
    """(ref cfg, port cfg, ref params, port MoE, ref extra MLPs, port
    extra MLPs), the MLPs those the config adds beside the experts."""
    cfg = jconfigs.reduced_config(arch, **overrides)
    tcfg = tconfigs.reduced_config(arch, **overrides)
    k = jax.random.split(jax.random.PRNGKey(seed), 3)
    params = _values(jmoe.init_moe(k[0], cfg))
    moe = _load(tmoe.MoE(tcfg, "cpu"), params)
    extra, textra = {}, {}
    for name, flag, key in (("mlp_res", cfg.dense_residual, k[1]),
                            ("mlp_shared", cfg.shared_expert, k[2])):
        if flag:
            extra[name] = _values(jlayers.init_mlp(key, cfg))
            textra[name] = _load(tlayers.MLP(tcfg, "cpu"), extra[name])
    return cfg, tcfg, params, moe, extra, textra


def _x(shape, seed: int = 1, shift: float = 0.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            + shift).astype(np.float32)


def _apply_both(arch, x, **overrides):
    cfg, tcfg, params, moe, extra, textra = _pair(arch, **overrides)
    y, aux = jmoe.apply_moe(params, jnp.asarray(x), cfg, REPLICATED,
                            **extra)
    ty, taux = tmoe.apply_moe(moe, torch.from_numpy(x), tcfg, **textra)
    return (np.asarray(y), float(aux)), (ty, float(taux)), (tcfg, moe)


# -- capacity and routing ------------------------------------------------------

@pytest.mark.parametrize("k,cf", list(itertools.product(
    (1, 2), (0.25, 1.0, 1.25, 4.0))))
def test_capacity_equals_reference(k, cf):
    base = jconfigs.reduced_config("jamba-v0.1-52b")
    tbase = tconfigs.reduced_config("jamba-v0.1-52b")
    for tokens, E in itertools.product((1, 2, 3, 8, 13, 64, 1000, 16384),
                                       (4, 16, 128)):
        over = dict(n_experts=E, top_k=k, capacity_factor=cf, tp=1)
        want = jmoe.capacity(tokens, jconfigs.reduced_config(
            "jamba-v0.1-52b", **over))
        got = tmoe.capacity(tokens, tconfigs.reduced_config(
            "jamba-v0.1-52b", **over))
        assert got == want, (tokens, E)
    assert tmoe.capacity(4, tbase) == jmoe.capacity(4, base)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "llama4-maverick-400b-a17b"])
def test_routing_equals_reference(arch):
    cfg, tcfg, params, moe, _, _ = _pair(arch)
    xf = _x((48, cfg.d_model))
    gate, idx, aux = jmoe._routing(params, jnp.asarray(xf), cfg)
    tgate, tidx, taux = tmoe._routing(moe, torch.from_numpy(xf), tcfg)
    assert tidx.shape == (48, cfg.top_k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    assert rel_frobenius(tgate.numpy(), np.asarray(gate)) <= TOL
    assert abs(float(taux) - float(aux)) <= TOL * abs(float(aux))
    # the gates of a token are renormalised to sum to 1
    torch.testing.assert_close(tgate.sum(-1), torch.ones(48))


def test_positions_are_slot_major_running_counts():
    """idx.T.reshape(-1) puts every token's first choice before any second
    choice; an assignment's position is its expert's count before it."""
    idx = torch.tensor([[0, 1], [0, 2], [1, 0], [0, 1]])
    pos = tmoe.positions(idx.T.reshape(-1), 3)
    # first choices 0, 0, 1, 0 then second choices 1, 2, 0, 1
    assert pos.tolist() == [0, 1, 0, 2, 1, 0, 3, 2]


# -- the layer -----------------------------------------------------------------

# the published expert count: arctic's and llama4's 128 (the reduced
# configs keep 4) at the reduced widths
PUBLISHED = {"n_experts": 128}


@pytest.mark.parametrize("arch,over", [
    ("jamba-v0.1-52b", {}), ("arctic-480b", {}),
    ("llama4-maverick-400b-a17b", {}), ("arctic-480b", PUBLISHED),
    ("llama4-maverick-400b-a17b", PUBLISHED)],
    ids=["top2", "top2_dense_residual", "top1_shared_expert",
         "top2_dense_residual_128", "top1_shared_expert_128"])
def test_apply_moe_equals_reference(arch, over):
    x = _x((2, 16, 64))
    (y, aux), (ty, taux), (tcfg, moe) = _apply_both(arch, x, **over)
    assert tcfg.n_experts == over.get("n_experts", 4)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    assert rel_frobenius(ty.numpy(), y) <= TOL
    assert abs(taux - aux) <= TOL * abs(aux)


@pytest.mark.parametrize("arch,over", [
    ("jamba-v0.1-52b", {}), ("arctic-480b", {}),
    ("llama4-maverick-400b-a17b", {}), ("arctic-480b", PUBLISHED),
    ("llama4-maverick-400b-a17b", PUBLISHED)],
    ids=["jamba-v0.1-52b", "arctic-480b", "llama4-maverick-400b-a17b",
         "arctic-480b-128", "llama4-maverick-400b-a17b-128"])
def test_low_capacity_drops_the_same_tokens(arch, over):
    """capacity_factor 0.25: most assignments are dropped; the outputs
    equal the reference's, so the same tokens are kept."""
    x = _x((2, 16, 64), seed=2)
    (y, aux), (ty, taux), (tcfg, moe) = _apply_both(arch, x,
                                                    capacity_factor=0.25,
                                                    **over)
    assert rel_frobenius(ty.numpy(), y) <= TOL
    xf = torch.from_numpy(x.reshape(32, 64))
    _, idx, _ = tmoe._routing(moe, xf, tcfg)
    C = tmoe.capacity(32, tcfg)
    kept = tmoe.positions(idx.T.reshape(-1), tcfg.n_experts) < C
    assert 0 < int(kept.sum()) < kept.numel()
    # a token none of whose assignments was kept gets nothing from the
    # experts (only the dense residual / shared expert, if any)
    lost = ~kept.view(tcfg.top_k, 32).any(0)
    if lost.any() and not (tcfg.dense_residual or tcfg.shared_expert):
        assert not ty.reshape(32, 64)[lost].any()


@pytest.mark.parametrize("k", [1, 2])
def test_dropped_token_does_not_overwrite_slot_c_minus_1(k):
    """Every token routes its first choice to expert 0, so the tokens past
    the capacity are dropped onto expert 0's last slot, which the token at
    position C - 1 owns: that token must keep its output (the reference
    adds the dropped tokens as zeros there; a scatter that writes them
    would zero it)."""
    arch = "jamba-v0.1-52b"
    cfg, tcfg, params, moe, _, _ = _pair(arch, top_k=k, capacity_factor=1.0)
    router = np.zeros_like(params["router"])
    router[:, 0] = 1.0                     # expert 0 wins by far
    router[:, 1:] = 0.01 * _x(router[:, 1:].shape, seed=3)
    params["router"] = router
    _load(moe, params)
    x = _x((1, 12, 64), seed=4, shift=1.0)  # sum(x) > 0 for every token
    y, _ = jmoe.apply_moe(params, jnp.asarray(x), cfg, REPLICATED)
    ty, _ = tmoe.apply_moe(moe, torch.from_numpy(x), tcfg)
    xf = torch.from_numpy(x[0])
    _, idx, _ = tmoe._routing(moe, xf, tcfg)
    assert (idx[:, 0] == 0).all()
    C = tmoe.capacity(12, tcfg)
    assert C < 12                          # tokens C.. are dropped
    owner = C - 1                          # expert 0's slot C - 1
    assert ty[0, owner].abs().max() > 0.0
    assert rel_frobenius(ty.numpy(), np.asarray(y)) <= TOL
    assert rel_frobenius(ty[0, owner].numpy(), np.asarray(y)[0, owner]) <= TOL
    if k == 1:                             # the dropped ones get nothing
        assert not ty[0, C:].any()


@pytest.mark.parametrize("E_local", [1, 2])
def test_expert_shares_add_up_to_the_whole_layer(E_local):
    """``_dispatch_compute_combine`` over each share of the experts (the
    reference's ``e0`` / ``E_local``, one device's share on a mesh) sums
    to the whole layer, and each share equals the reference's."""
    cfg, tcfg, params, moe, _, _ = _pair("jamba-v0.1-52b", seed=5)
    xf = _x((24, cfg.d_model), seed=6)
    gate, idx, _ = tmoe._routing(moe, torch.from_numpy(xf), tcfg)
    E, k = cfg.n_experts, cfg.top_k
    C = tmoe.capacity(24, tcfg)
    whole = tmoe._dispatch_compute_combine(
        torch.from_numpy(xf), gate, idx, moe.wi, moe.wg, moe.wo, E=E, k=k,
        C=C, e0=0, E_local=E)
    parts = 0
    for e0 in range(0, E, E_local):
        sl = slice(e0, e0 + E_local)
        part = tmoe._dispatch_compute_combine(
            torch.from_numpy(xf), gate, idx, moe.wi[sl], moe.wg[sl],
            moe.wo[sl], E=E, k=k, C=C, e0=e0, E_local=E_local)
        want = jmoe._dispatch_compute_combine(
            jnp.asarray(xf), jnp.asarray(gate.numpy()),
            jnp.asarray(idx.numpy()), params["wi"][sl], params["wg"][sl],
            params["wo"][sl], E=E, k=k, C=C, e0=e0, E_local=E_local)
        assert rel_frobenius(part.numpy(), np.asarray(want)) <= TOL
        parts = parts + part
    assert rel_frobenius(parts.numpy(), whole.numpy()) <= TOL


def test_init_shapes_and_dtypes_match_reference():
    cfg = jconfigs.reduced_config("arctic-480b", dtype="bfloat16")
    tcfg = tconfigs.reduced_config("arctic-480b", dtype="bfloat16")
    params = _values(jmoe.init_moe(jax.random.PRNGKey(0), cfg))
    moe = tmoe.MoE(tcfg, "cpu")
    with torch.no_grad():
        moe.reset_parameters(torch.Generator().manual_seed(0))
    for name, t in moe.state_dict().items():
        assert tuple(t.shape) == params[name].shape, name
        assert str(t.dtype).split(".")[1] == params[name].dtype.name, name
    assert moe.router.dtype == torch.float32
    # the scales: 1/sqrt(d) in, 1/sqrt(f) out
    assert abs(float(moe.wi.float().std()) * 8 - 1) < 0.05
    assert abs(float(moe.wo.float().std()) * 128 ** 0.5 - 1) < 0.05
