"""The port's AdamW (``repro_torch.optim.adamw``) against the reference's
(``repro.optim.adamw``), on the CPU, on seeded numpy parameter and
gradient trees (flat dicts of names, so both packages take the leaves in
the same order).

Contracts:

* ``_quantize`` of the same fp32 input: the int8 bytes and the fp32 scales
  bitwise equal to the reference's op-by-op result (XLA's jit rewrites the
  division by 127 into a multiply by its reciprocal, which can move a
  scale by one ulp; the port divides, as the reference's code says);
* ``lr_schedule`` bitwise in the warmup and within lr x 2^-22 after it
  (the two libraries' fp32 cos may differ by an ulp, about 2^-24, and
  1 + cos near the end of the decay cancels, so the difference counts
  against lr, not against the value); ``global_norm`` within 2 ulps
  (other summation orders);
* one ``update`` from the same state with the same gradients, clipping
  off: parameters within 1 fp32 ulp, fp32 and bf16 moments bitwise, the
  int8 mode's bytes equal and scales within 1 ulp (its dequantised
  sqrt(v) squared feeds the next quantisation); with clipping the clip
  factor carries the norm's ulps, so parameters within 4 ulps of the
  largest parameter;
* ``convert.adamw_state_to_port``/``adamw_state_to_reference`` carry a
  state across bitwise, int8 pairs and the count too.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch.optim import adamw as tadamw

from _torch_parity import ulp_distance

SHAPES = {"a": (5, 130), "b": (3, 4, 256), "c": (7,), "d": (64, 64)}
MOMENTS = ["float32", "bfloat16", "int8"]


def _tree(seed: int, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _cfgs(**kw):
    return jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t).astype(np.float32) if np.asarray(t).dtype.name \
        == "bfloat16" else np.asarray(t)


def _port_state(js, moment_dtype: str) -> tadamw.OptState:
    """The reference's state as the port's, leaf for leaf."""
    def moment(v, which):
        if isinstance(v, dict):
            return {"q": torch.tensor(np.asarray(v["q"])),
                    "s": torch.tensor(np.asarray(v["s"]))}
        t = torch.tensor(np.asarray(v).astype(np.float32))
        bf16 = moment_dtype == "bfloat16" or (moment_dtype == "int8"
                                              and which == "m")
        return t.to(torch.bfloat16) if bf16 else t
    return tadamw.OptState(
        m={k: moment(v, "m") for k, v in js.m.items()},
        v={k: moment(v, "v") for k, v in js.v.items()},
        count=torch.tensor(int(js.count), dtype=torch.int32))


@pytest.mark.parametrize("shape", [(1000, 256), (37, 130), (5, 7),
                                   (3, 4, 300), (2, 128)])
def test_quantize_bytes_and_scales_equal(shape):
    rng = np.random.default_rng(len(shape) + shape[-1])
    x = np.abs(rng.standard_normal(shape)).astype(np.float32)
    x *= rng.choice([0.0, 1e-6, 1e-3, 1.0, 1e3], size=shape).astype(
        np.float32)
    want = jadamw._quantize(jnp.asarray(x))
    got = tadamw._quantize(torch.tensor(x))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    np.testing.assert_array_equal(
        tadamw._dequantize(got, shape).numpy(),
        np.asarray(jadamw._dequantize(want, shape)))


def test_quantize_rounds_up():
    """sqrt(v) read back is never below the truth (the reference's rule:
    a coordinate below one quantum reads as a full quantum, not 0)."""
    x = torch.tensor(np.abs(np.random.default_rng(3).standard_normal(
        (4, 300))).astype(np.float32)) * torch.logspace(-8, 0, 300)
    back = tadamw._dequantize(tadamw._quantize(x), x.shape)
    assert bool((back >= x).all()) and bool((back[x > 0] > 0).all())


def test_lr_schedule_matches_reference():
    jcfg, tcfg = _cfgs(lr=3e-3, warmup_steps=7, decay_steps=60,
                       min_lr_ratio=0.1)
    steps = np.arange(0, 80, dtype=np.int32)
    want = np.asarray(jadamw.lr_schedule(jcfg, jnp.asarray(steps)))
    got = tadamw.lr_schedule(tcfg, torch.tensor(steps)).numpy()
    np.testing.assert_array_equal(got[:8], want[:8])
    np.testing.assert_allclose(got, want, rtol=0, atol=jcfg.lr * 2 ** -22)
    assert got[0] == 0.0 and got.argmax() == 7


def test_global_norm_matches_reference():
    tree = _tree(1, scale=3.0)
    want = np.asarray(jadamw.global_norm({k: jnp.asarray(v)
                                          for k, v in tree.items()}))
    got = tadamw.global_norm({k: torch.tensor(v) for k, v in tree.items()})
    assert got.dtype == torch.float32
    assert int(ulp_distance(got.numpy(), want).max()) <= 2


@pytest.mark.parametrize("moment_dtype", MOMENTS)
def test_init_matches_reference(moment_dtype):
    jcfg, tcfg = _cfgs(moment_dtype=moment_dtype)
    p = _tree(0)
    js = jadamw.init({k: jnp.asarray(v) for k, v in p.items()}, jcfg)
    ts = tadamw.init({k: torch.tensor(v) for k, v in p.items()}, tcfg)
    for which in ("m", "v"):
        for k in p:
            want = jax.tree.leaves(getattr(js, which)[k])
            got = getattr(ts, which)[k]
            got = [got["q"], got["s"]] if isinstance(got, dict) else [got]
            assert [tuple(g.shape) for g in got] == [w.shape for w in want]
            assert [str(g.dtype).split(".")[-1] for g in got] == \
                [str(w.dtype) for w in want]
            for g, w in zip(got, want):
                np.testing.assert_array_equal(_np(g), _np(w))
    assert int(ts.count) == 0 and ts.count.dtype == torch.int32


def test_init_rejects_an_unknown_moment_dtype():
    with pytest.raises(ValueError, match="moment_dtype"):
        tadamw.init({"a": torch.zeros(3)},
                    tadamw.AdamWConfig(moment_dtype="fp8"))


@pytest.mark.parametrize("clip", [1e9, 1.0])
@pytest.mark.parametrize("moment_dtype", MOMENTS)
def test_update_matches_reference(moment_dtype, clip):
    """Four steps; before each, the reference's state is carried into the
    port, and one update of each from it is held to the contract."""
    jcfg, tcfg = _cfgs(lr=1e-2, warmup_steps=2, decay_steps=10,
                       moment_dtype=moment_dtype, grad_clip=clip)
    jp = {k: jnp.asarray(v) for k, v in _tree(0).items()}
    js = jadamw.init(jp, jcfg)
    for step in range(4):
        g = _tree(10 + step, scale=0.3)
        tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
        ts = _port_state(js, moment_dtype)
        before = {k: t.clone() for k, t in tp.items()}
        jp, js, jm = jadamw.update({k: jnp.asarray(v) for k, v in g.items()},
                                   js, jp, jcfg)
        out, ts, tm = tadamw.update({k: torch.tensor(v)
                                     for k, v in g.items()}, ts, tp, tcfg)
        assert out is tp and int(ts.count) == step + 1
        for k in SHAPES:
            want, got = np.asarray(jp[k]), tp[k].numpy()
            assert not np.array_equal(got, before[k].numpy())
            if clip > 1e8:
                assert int(ulp_distance(got, want).max()) <= 1, (step, k)
            else:
                tol = 4 * np.finfo(np.float32).eps * np.abs(want).max()
                np.testing.assert_allclose(got, want, rtol=0, atol=tol)
            if clip < 1e8:
                continue
            if moment_dtype == "int8":
                np.testing.assert_array_equal(_np(ts.m[k]), _np(js.m[k]))
                np.testing.assert_array_equal(ts.v[k]["q"].numpy(),
                                              np.asarray(js.v[k]["q"]))
                assert int(ulp_distance(ts.v[k]["s"].numpy(),
                                        np.asarray(js.v[k]["s"])).max()) <= 1
            else:
                for which in ("m", "v"):
                    np.testing.assert_array_equal(
                        _np(getattr(ts, which)[k]),
                        _np(getattr(js, which)[k]))
        assert int(ulp_distance(tm["lr"].numpy(),
                                np.asarray(jm["lr"])).max()) == 0
        assert int(ulp_distance(tm["grad_norm"].numpy(),
                                np.asarray(jm["grad_norm"])).max()) <= 2


def test_grad_clipping_reports_the_norm():
    _, tcfg = _cfgs(grad_clip=1.0)
    p = {"a": torch.zeros(4)}
    state = tadamw.init(p, tcfg)
    _, _, metrics = tadamw.update({"a": torch.full((4,), 100.0)}, state, p,
                                  tcfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)


def test_update_leaves_gradients_and_old_state_alone():
    _, tcfg = _cfgs(moment_dtype="float32")
    p = {k: torch.tensor(v) for k, v in _tree(0).items()}
    g = {k: torch.tensor(v) for k, v in _tree(1).items()}
    g0 = {k: t.clone() for k, t in g.items()}
    state = tadamw.init(p, tcfg)
    _, new, _ = tadamw.update(g, state, p, tcfg)
    assert all(torch.equal(g[k], g0[k]) for k in g)
    assert all(not state.m[k].any() for k in p) and int(state.count) == 0
    assert all(new.m[k].any() for k in p)


def _leaves(state: tadamw.OptState) -> list:
    return [t for which in (state.m, state.v) for k in sorted(which)
            for t in ((which[k],) if torch.is_tensor(which[k])
                      else (which[k]["q"], which[k]["s"]))]


@pytest.mark.parametrize("moment_dtype", MOMENTS)
def test_update_in_place_writes_the_functional_update_into_the_state(
        moment_dtype):
    """``in_place`` (the train step's, which consumes its state): three
    steps give bitwise the functional update's parameters and moments,
    and each new moment is the state's own tensor, so that no second set
    of moments is allocated (the functional update's peak held both: 29.4
    GB more for jamba's 2-layer stand-in on the card)."""
    _, tcfg = _cfgs(lr=1e-2, warmup_steps=2, decay_steps=10,
                    moment_dtype=moment_dtype)
    pf = {k: torch.tensor(v) for k, v in _tree(0).items()}
    pi = {k: t.clone() for k, t in pf.items()}
    sf, si = tadamw.init(pf, tcfg), tadamw.init(pi, tcfg)
    for step in range(3):
        g = {k: torch.tensor(v) for k, v in _tree(10 + step, 0.3).items()}
        before = _leaves(sf)
        saved = [t.clone() for t in before]
        _, sf, _ = tadamw.update(g, sf, pf, tcfg)
        assert all(torch.equal(a, b) for a, b in zip(before, saved))
        held = _leaves(si)
        _, si, _ = tadamw.update(g, si, pi, tcfg, in_place=True)
        assert all(a is b for a, b in zip(_leaves(si), held))
        assert all(torch.equal(pi[k], pf[k]) for k in pf)
        assert all(torch.equal(a, b)
                   for a, b in zip(_leaves(si), _leaves(sf)))
        assert int(si.count) == int(sf.count) == step + 1


@pytest.mark.parametrize("moment_dtype", MOMENTS)
def test_state_carried_both_ways(moment_dtype):
    """``convert``: the reference's state after two steps as the port's
    and back, bitwise, on the LM's parameter tree of a reduced model."""
    from repro import configs as jconfigs
    from repro.models import transformer as jtfm
    from repro_torch import configs as tconfigs
    from repro_torch import convert
    cfg = jconfigs.reduced_config("jamba-v0.1-52b")
    tcfg = tconfigs.reduced_config("jamba-v0.1-52b")
    params = jtfm.param_values(jtfm.init_model(jax.random.PRNGKey(0), cfg))
    jcfg, _ = _cfgs(moment_dtype=moment_dtype)
    js = jadamw.init(params, jcfg)
    for seed in (1, 2):
        leaves, treedef = jax.tree.flatten(params)
        rng = np.random.default_rng(seed)
        grads = treedef.unflatten([jnp.asarray(rng.standard_normal(
            l.shape).astype(np.float32)) for l in leaves])
        params, js, _ = jadamw.update(grads, js, params, jcfg)
    ts = convert.adamw_state_to_port(js, tcfg, device="cpu")
    names = set(convert.lm_state_dict(jax.tree.map(np.asarray, params),
                                      tcfg))
    assert set(ts.m) == set(ts.v) == names and int(ts.count) == 2
    back = convert.adamw_state_to_reference(ts, tcfg)
    assert back["count"] == 2
    for which in ("m", "v"):
        want = jax.tree_util.tree_leaves_with_path(getattr(js, which))
        got = dict(jax.tree_util.tree_leaves_with_path(back[which]))
        assert len(got) == len(want)
        for path, w in want:
            np.testing.assert_array_equal(got[path], _np(w),
                                          err_msg=jax.tree_util.keystr(path))
