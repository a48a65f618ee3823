"""The port's sharded train step, its checkpoints across meshes and its
two CLIs at ``--model-parallel 4``, on a 2 x 4 ("data", "model") mesh of
8 gloo processes on the CPU (``tests/_torch_dist.py``; the bodies in
``tests/_torch_dist_cases.py``), fp32, reduced configs with ``tp`` 4.

Cases, one world for all of them:
* one train step of a dense cell (granite-8b at 2 layers, B 4 x 32: the
  reference's own sharded-train-step cell), a hybrid one (reduced jamba
  cut to its 2-layer stand-in: a mamba layer, then attention with an MoE
  FFN) and an MoE one (arctic, ``capacity_factor`` 4, where nothing is
  dropped): the loss within ``TOL`` relative, every updated parameter
  within ``TOL`` relative Frobenius, and the gradient norm within
  ``TOL``, of the reference's ``jax.value_and_grad`` of ``loss_fn`` and
  ``adamw.update`` on one device.  The norm is the logical gradient's:
  a leaf replicated over an axis counts once;
* a leaf saved from ("data", "model") on a (4, 2) mesh restores bitwise
  onto a (2, 2) mesh of 4 of the ranks placed as ("model", "data");
* 2 steps on (2, 4), a save, a restore onto (4, 2), 2 more steps: within
  1e-6 of 4 uninterrupted steps; restored onto (2, 4) instead, bitwise;
* ``train.main`` and ``serve.main`` with ``--reduced --model-parallel 4``
  in the 8-process world: the losses of the 1-process run (a (1, 1)
  mesh) within ``TOL`` and its tokens exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro.parallel.sharding import REPLICATED
from repro_torch import convert
from repro_torch.launch import serve, train

from _torch_dist import run_world
from _torch_parity import ref_lm_params, rel_frobenius

TOL = 1e-5
CELLS = {
    "dense": ("granite-8b", {"n_layers": 2}, (4, 32)),
    "hybrid": ("jamba-v0.1-52b", {"n_layers": 2, "attn_every": 2,
                                  "moe_every": 2, "capacity_factor": 4.0},
               (4, 16)),
    "moe": ("arctic-480b", {"capacity_factor": 4.0}, (4, 16)),
}
CKPT = ("olmo-1b", {})
CLI_TRAIN = ["--arch", "olmo-1b", "--reduced", "--steps", "3",
             "--global-batch", "4", "--seq-len", "16", "--log-every", "100"]
CLI_SERVE = ["--arch", "olmo-1b", "--reduced", "--batch", "4",
             "--prompt-len", "12", "--gen-len", "4"]


def _over(over):
    return dict(over, tp=4)


def _reference_step(jcfg, params, tokens):
    batch = {"tokens": jnp.asarray(tokens)}
    opt_cfg = jadamw.AdamWConfig()

    def loss(p):
        return jtfm.loss_fn(p, batch, jcfg, REPLICATED)

    (l, _), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    new, _, metrics = jadamw.update(g, jadamw.init(params, opt_cfg), params,
                                    opt_cfg)
    return (float(l), float(metrics["grad_norm"]),
            {k: np.asarray(v) for k, v in
             convert.lm_state_dict(new, jcfg).items()})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_train")
    rng = np.random.default_rng(0)
    inputs, want = {}, {}
    for name, (arch, over, (b, s)) in CELLS.items():
        jcfg = jconfigs.reduced_config(arch, **_over(over))
        params = ref_lm_params(jcfg)
        inputs.update({f"{name}/p/{k}": np.asarray(v) for k, v in
                       convert.lm_state_dict(params, jcfg).items()})
        tokens = rng.integers(0, jcfg.vocab_size, (b, s))
        inputs[f"{name}/tokens"] = tokens
        want[name] = _reference_step(jcfg, params, tokens)
    jcfg = jconfigs.reduced_config(CKPT[0], **_over(CKPT[1]))
    inputs.update({f"ckpt/p/{k}": np.asarray(v) for k, v in
                   convert.lm_state_dict(ref_lm_params(jcfg), jcfg).items()})
    inputs["ckpt/tokens"] = rng.integers(0, jcfg.vocab_size, (4, 4, 16))
    np.savez(tmp / "train_inputs.npz", **inputs)
    out = run_world(
        8, "trainer", tmp,
        cells={n: {"arch": a, "overrides": _over(o)}
               for n, (a, o, _) in CELLS.items()},
        ckpt={"arch": CKPT[0], "overrides": _over(CKPT[1])},
        cli={"train": CLI_TRAIN + ["--model-parallel", "4"],
             "serve": CLI_SERVE + ["--model-parallel", "4"]})
    return {"out": out, "got": np.load(tmp / "train_out.npz"),
            "want": want}


@pytest.mark.parametrize("cell", list(CELLS))
def test_train_step_matches_reference(world, cell):
    loss, gnorm, params = world["want"][cell]
    got = world["out"][cell]
    assert abs(got["loss"] - loss) <= TOL * abs(loss)
    assert abs(got["grad_norm"] - gnorm) <= TOL * abs(gnorm)
    for k, a in params.items():
        assert rel_frobenius(world["got"][f"{cell}/{k}"], a) < TOL, k
    # FSDP gathers, their reduce-scatters and the "model" all-reduces ran
    counts = got["collectives"]
    assert counts["reduce_scatter:data"] > 0
    assert counts["all_reduce:model"] > 0


def test_checkpoint_leaf_restores_across_meshes(world):
    leaf = world["out"]["leaf"]
    assert leaf == {"ok": True, "shape": [4, 4], "step": 3}


@pytest.mark.parametrize("target", ["cross", "same"])
def test_checkpoint_resume_across_meshes(world, target):
    got = world["got"]
    keys = [k[len("ckpt/full/"):] for k in got.files
            if k.startswith("ckpt/full/")]
    assert keys
    for k in keys:
        a, b = got[f"ckpt/{target}/{k}"], got[f"ckpt/full/{k}"]
        if target == "same":
            np.testing.assert_array_equal(a, b)
        else:
            assert rel_frobenius(a, b) < 1e-6, k


def test_cli_train_at_model_parallel_4(world):
    one = train.main(CLI_TRAIN + ["--model-parallel", "4"], device="cpu")
    got = world["out"]["cli_train"]
    assert len(got) == len(one) == 3
    np.testing.assert_allclose(got, one, rtol=TOL)
    assert world["out"]["cli_train_collectives"]["all_reduce:model"] > 0


def test_cli_serve_at_model_parallel_4(world):
    one = serve.main(CLI_SERVE + ["--model-parallel", "4"], device="cpu")
    np.testing.assert_array_equal(np.asarray(world["out"]["cli_serve"]),
                                  one)
