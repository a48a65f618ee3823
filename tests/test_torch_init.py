"""The port's seeded init (``models.transformer.init_model``) on the CPU:
its memory is bounded and its values are what they were.

``layers._normal`` fills a parameter in place (the fp32 draw scaled in
place and copied, which casts it), and ``MoE.reset_parameters`` draws each
expert tensor one expert's matrix at a time.  Held here:

- at the published 128 experts (reduced widths: d 64, d_ff 128), no draw
  is a whole (E, d, f) tensor: the MoE's draws are the router, then E
  one-expert matrices of ``wi``, of ``wg`` and of ``wo``, in expert order;
  and no draw of the whole model is larger than its largest non-expert
  parameter;
- each expert keeps the reference's scale (``init_moe``: 1/sqrt(d) for
  ``wi`` and ``wg``, 1/sqrt(f) for ``wo``), within sampling error: the
  standard deviation of a one-expert matrix of n = 8192 draws is off its
  scale by about 1/sqrt(2n) = 0.8% (one sigma); the bound is 5%;
- a dense model's weights are bitwise those of the whole-tensor draw
  ``(scale * torch.randn(shape, fp32)).to(dtype)``, replayed here from the
  same generator in the order the init draws them;
- two inits with one seed are bitwise equal.

The reference draws from ``jax.random``; no test compares the two
packages' seeded values (the parity tests carry the reference's across).
"""
import math

import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm

EXPERTS = 128
SCALE_TOL = 0.05
MOE_ARCHS = ("arctic-480b", "llama4-maverick-400b-a17b")


@pytest.fixture
def draws(monkeypatch):
    """The shape of every ``torch.randn`` call, in order."""
    shapes = []
    randn = torch.randn

    def recorded(*args, **kw):
        out = randn(*args, **kw)
        shapes.append(tuple(out.shape))
        return out
    monkeypatch.setattr(torch, "randn", recorded)
    return shapes


def _moe_config(arch: str):
    return tconfigs.reduced_config(arch, n_experts=EXPERTS)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_experts_are_drawn_one_at_a_time(arch, draws):
    cfg = _moe_config(arch)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    moe = tmoe.MoE(cfg, "cpu")
    with torch.no_grad():
        moe.reset_parameters(torch.Generator().manual_seed(0))
    assert draws == [(d, E)] + [(d, f)] * (2 * E) + [(f, d)] * E
    draws.clear()
    model = ttfm.init_model(cfg, seed=0, device="cpu")
    experts = {n for n, _ in model.named_parameters()
               if n.rsplit(".", 1)[-1] in ("wi", "wg", "wo")
               and ".ffn." in n}
    largest_other = max(p.numel() for n, p in model.named_parameters()
                        if n not in experts)
    assert experts and max(math.prod(s) for s in draws) <= largest_other
    n_moe = cfg.ffn_kinds().count("moe")
    assert draws.count((d, f)) >= 2 * E * n_moe
    assert draws.count((f, d)) >= E * n_moe
    assert E * d * f not in {math.prod(s) for s in draws}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_each_expert_keeps_the_reference_scale(arch):
    cfg = _moe_config(arch)
    model = ttfm.init_model(cfg, seed=1, device="cpu")
    d, f = cfg.d_model, cfg.d_ff
    for layer in model.layers:
        for name, fan_in in (("wi", d), ("wg", d), ("wo", f)):
            w = getattr(layer.ffn, name).float()
            std = w.flatten(1).std(dim=1) * math.sqrt(fan_in)
            mean = w.flatten(1).mean(dim=1) * math.sqrt(fan_in)
            assert w.shape[0] == EXPERTS
            assert (std - 1).abs().max() < SCALE_TOL, name
            assert mean.abs().max() < SCALE_TOL, name
    # the experts differ from each other: one draw each
    wi = model.layers[0].ffn.wi
    assert not torch.equal(wi[0], wi[1])


def _whole_tensor_init(model: ttfm.Transformer, cfg, seed: int) -> dict:
    """The whole-tensor draws ``(scale * randn(shape)).to(dtype)`` of a
    dense model, in ``init_model``'s order, from a generator seeded with
    ``seed``: the embedding, then each layer's mixer, cross attention and
    FFN (the encoder's layers after the decoder's)."""
    gen = torch.Generator().manual_seed(seed)
    want = {}

    def draw(name, w, scale):
        x = torch.randn(w.shape, generator=gen, dtype=torch.float32)
        want[name] = (scale * x).to(w.dtype)

    emb = model.embed
    draw("embed.tok", emb.tok, 0.02)
    if not cfg.tie_embeddings:
        draw("embed.head", emb.head, 1.0 / math.sqrt(cfg.d_model))
    if cfg.pos_embed == "learned":
        draw("embed.pos", emb.pos, 0.02)
    layers = [f"layers.{i}" for i in range(len(model.layers))]
    if cfg.family == "encdec":
        layers += [f"encoder.layers.{i}"
                   for i in range(len(model.encoder.layers))]
    mods = dict(model.named_modules())
    for prefix in layers:
        for part in ("mixer", "cross", "ffn"):
            mod = mods.get(f"{prefix}.{part}")
            if isinstance(mod, tattn.Attention):
                sq = 1.0 / math.sqrt(cfg.d_model)
                so = 1.0 / math.sqrt(cfg.padded_heads * cfg.head_dim)
                for name, scale in (("wq", sq), ("wk", sq), ("wv", sq),
                                    ("wo", so)):
                    draw(f"{prefix}.{part}.{name}", getattr(mod, name),
                         scale)
                want[f"{prefix}.{part}.wq"][:, cfg.n_heads:, :] = 0
            elif isinstance(mod, tlayers.MLP):
                names = ("wi", "wg", "wo") if mod.kind == "swiglu" \
                    else ("wi", "wo")
                d_ff = mod.wi.shape[1]
                for name in names:
                    scale = 1.0 / math.sqrt(d_ff if name == "wo"
                                            else cfg.d_model)
                    draw(f"{prefix}.{part}.{name}", getattr(mod, name),
                         scale)
    return want


@pytest.mark.parametrize("arch,dtype", [("olmo-1b", "float32"),
                                        ("olmo-1b", "bfloat16"),
                                        ("granite-8b", "bfloat16"),
                                        ("whisper-small", "bfloat16")])
def test_dense_weights_are_bitwise_the_whole_tensor_draw(arch, dtype):
    cfg = tconfigs.reduced_config(arch, dtype=dtype)
    model = ttfm.init_model(cfg, seed=4, device="cpu")
    want = _whole_tensor_init(model, cfg, seed=4)
    got = model.state_dict()
    drawn = {n for n in got if n not in want and n.rsplit(".", 1)[-1] in
             ("tok", "head", "pos", "wq", "wk", "wv", "wo", "wi", "wg")}
    assert not drawn, f"a drawn parameter the replay misses: {drawn}"
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        assert torch.equal(got[name].view(torch.int16 if w.dtype ==
                                          torch.bfloat16 else torch.int32),
                           w.view(torch.int16 if w.dtype == torch.bfloat16
                                  else torch.int32)), name


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_one_seed_inits_bitwise_equal_models(arch):
    cfg = _moe_config(arch)
    a = ttfm.init_model(cfg, seed=7, device="cpu").state_dict()
    b = ttfm.init_model(cfg, seed=7, device="cpu").state_dict()
    c = ttfm.init_model(cfg, seed=8, device="cpu").state_dict()
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert not torch.equal(a["layers.0.ffn.wi"], c["layers.0.ffn.wi"])
