"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

Each test feeds the same numpy input to a function of the JAX reference and
to its port, then applies one named contract:

  ``bitwise``        identical arrays;
  ``ulp``            at most ``tol`` float32 units in the last place apart;
  ``rel_frobenius``  ||got - want||_F / ||want||_F <= ``tol``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def ulp_distance(a, b) -> np.ndarray:
    """Float32 units in the last place between a and b (elementwise)."""
    a = np.ascontiguousarray(to_numpy(a), np.float32).view(np.int32)
    b = np.ascontiguousarray(to_numpy(b), np.float32).view(np.int32)
    # map the sign-magnitude bit patterns onto one ordered integer line
    a = np.where(a < 0, np.int64(-2 ** 31) - a, a).astype(np.int64)
    b = np.where(b < 0, np.int64(-2 ** 31) - b, b).astype(np.int64)
    return np.abs(a - b)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of the bfloat16 numbers at |x| (8 significant bits)."""
    _, e = torch.frexp(x.abs().float().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8)


def rel_frobenius(got, want) -> float:
    got = to_numpy(got).astype(np.float64)
    want = to_numpy(want).astype(np.float64)
    return float(np.linalg.norm(got - want)) / max(
        float(np.linalg.norm(want)), 1e-30)


def assert_contract(got, want, contract: str, tol: float = 0.0) -> None:
    g, w = to_numpy(got), to_numpy(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if contract == "bitwise":
        np.testing.assert_array_equal(g, w)
    elif contract == "ulp":
        worst = int(ulp_distance(g, w).max(initial=0))
        assert worst <= tol, f"{worst} ulp > {tol}"
    elif contract == "rel_frobenius":
        err = rel_frobenius(g, w)
        assert err <= tol, f"rel-Frobenius {err:.3e} > {tol:g}"
    else:
        raise ValueError(f"unknown contract {contract!r}")


def subspace_cos(got, want) -> np.ndarray:
    """|cos| between matching columns (eigenvectors up to sign)."""
    g = to_numpy(got).astype(np.float64)
    w = to_numpy(want).astype(np.float64)
    g = g / np.linalg.norm(g, axis=0, keepdims=True)
    w = w / np.linalg.norm(w, axis=0, keepdims=True)
    return np.abs(np.sum(g * w, axis=0))


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test on a host without one (decided
    here, while the test runs, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode (run on the card with `python -m pytest -m "
                    "cuda tests/test_torch_*.py`)")
    return torch.device("cuda", 0)


def sym(n: int, seed: int = 0, scale: float = 1.0) -> np.ndarray:
    a = np.random.default_rng(seed).standard_normal((n, n)) * scale
    return ((a + a.T) / 2).astype(np.float32)


def data(m: int, n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((m, n)).astype(
        np.float32)


# the DLE scan's test grid: ragged n, tiles that do and do not divide it
# or 4 (the kernel's 16-byte loads), and the matrices of ``dle_matrix``
DLE_N = [1, 2, 3, 5, 33, 129, 784]
DLE_TILES = [1, 3, 4, 32, 128]
DLE_KINDS = ["random", "ties", "nan", "nan_inf"]


def dle_matrix(n: int, kind: str, seed: int = 0) -> np.ndarray:
    """A square fp32 matrix for the DLE scan: ``random`` symmetric;
    ``ties`` symmetric with 13 distinct values (equal maxima inside a
    16-byte vector, inside a tile and across tiles); ``nan`` random with
    NaNs off and on the diagonal; ``nan_inf`` that with +-inf as well."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        a = rng.integers(-6, 7, (n, n)).astype(np.float32)
        c = np.where(np.triu(np.ones((n, n), bool)), a, a.T)
    else:
        c = sym(n, seed=seed)
    if kind in ("nan", "nan_inf"):
        k = 2 + n // 64  # a share of the tiles, not all of them
        c[rng.integers(0, n, k), rng.integers(0, n, k)] = np.nan
        d = rng.integers(0, n)
        c[d, d] = np.nan
    if kind == "nan_inf":
        k = 1 + n // 128
        c[rng.integers(0, n, k), rng.integers(0, n, k)] = np.inf
        c[rng.integers(0, n, k), rng.integers(0, n, k)] = -np.inf
    return c.astype(np.float32)


# -- the LM stack ---------------------------------------------------------------

def ref_lm_params(cfg, seed: int = 0) -> dict:
    """The reference's initial parameters for ``cfg`` (the JAX package's
    ``ModelConfig``) as numpy, with every bias and norm parameter redrawn
    (they start at exact zeros and ones).  Imports JAX when called: the
    card's tests import this module and have no JAX."""
    import jax
    from repro.models import transformer as jtfm
    params = jax.tree.map(np.asarray, jtfm.param_values(
        jtfm.init_model(jax.random.PRNGKey(seed), cfg)))
    rng = np.random.default_rng(seed + 100)

    def redraw(path, a):
        name = jax.tree_util.keystr(path)
        if any(f"'{k}'" in name for k in ("bq", "bk", "bv", "bias")):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if "'scale'" in name:
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(redraw, params)


def lm_extra_inputs(cfg, batch: int, rng: np.random.Generator) -> dict:
    """The stub frontends' inputs a config takes beside its tokens, drawn
    N(0, 1) in fp32 from ``rng``: ``frames`` (batch, n_frames, d) for
    encdec, ``patches`` (batch, n_patches, d) for vlm; {} otherwise."""
    name = {"encdec": ("frames", "n_frames"),
            "vlm": ("patches", "n_patches")}.get(cfg.family)
    if name is None:
        return {}
    return {name[0]: rng.standard_normal(
        (batch, getattr(cfg, name[1]), cfg.d_model)).astype(np.float32)}


def lm_params_to_reference(model, cfg) -> dict:
    """The port's ``Transformer`` for ``cfg`` as the reference's parameter
    tree (the inverse of ``convert.lm_params_to_port``): nested dicts of
    numpy arrays (``convert.lm_tree``)."""
    from repro_torch import convert
    return convert.lm_tree({k: to_numpy(t)
                            for k, t in model.state_dict().items()}, cfg)


def compression_state_to_port(state) -> "object":
    """The reference's ``CompressionState`` (leaves keyed by the tuple of
    ``str`` path entries, ``("['blocks']", "['l0']", ...)``) as the
    port's, keyed by the dotted names of the reference's layout
    (``blocks.l0...``: ``launch.steps.stack_layers``), on the CPU."""
    from repro_torch.optim import compression as tcomp

    def port(tree):
        return {".".join(part[2:-2] for part in path):
                None if a is None else torch.as_tensor(np.array(a))
                for path, a in tree.items()}
    return tcomp.CompressionState(q=port(state.q), error=port(state.error))
