"""Guards of the port's boundaries: it imports neither JAX nor the JAX
package, it never falls back from the card to the CPU, and nothing about
the CUDA build happens before a kernel is called."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import _device
from repro_torch.backends import registry
from repro_torch.core import pca as tpca
from repro_torch.kernels import KERNELS, build, launch_counts
from repro_torch.kernels import ops as tops
from repro_torch.serving import solver as tsolver

PKG = pathlib.Path(repro_torch.__file__).resolve().parent
SRC = PKG.parent


def _run(code: str, **env) -> subprocess.CompletedProcess:
    full_env = dict(os.environ, PYTHONPATH=str(SRC), **env)
    return subprocess.run([sys.executable, "-c", code], env=full_env,
                          capture_output=True, text=True, timeout=120)


def test_import_leaves_jax_and_reference_out():
    code = ("import sys, repro_torch, repro_torch.convert, "
            "repro_torch.kernels.ops, repro_torch.serving.solver, "
            "repro_torch.configs, repro_torch.models.transformer, "
            "repro_torch.models.kv_compression, repro_torch.optim.spectral, "
            "repro_torch.optim.compression, repro_torch.launch.serve, "
            "repro_torch.launch.train, repro_torch.launch.steps, "
            "repro_torch.launch.pod_compression, "
            "repro_torch.launch.dryrun, "
            "repro_torch.optim.adamw, repro_torch.kernels.grad, "
            "repro_torch.checkpoint, repro_torch.data, repro_torch.runtime, "
            "repro_torch.configs.shapes, repro_torch.launch.accounting, "
            "repro_torch.parallel.collectives, "
            "repro_torch.parallel.ring_attention\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_source_imports_no_jax_and_no_reference():
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), (path, name)


def _module_level_imports(tree):
    """The imports a module runs when it is imported: at its top level and
    in its class bodies, not inside functions."""
    todo = list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            yield node
        todo.extend(ast.iter_child_nodes(node))


def test_torch_distributed_loads_lazily():
    """No module of the port imports ``torch.distributed`` when it is
    imported: the process group's module is imported inside the functions
    that use it (``torch`` itself may load it; the port asks for nothing
    of it before a world is started)."""
    seen = []
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for node in _module_level_imports(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                names = [node.module or ""]
                names += [f"{node.module}.{a.name}" for a in node.names]
            for name in names:
                assert not name.startswith("torch.distributed"), (path, name)
        seen.append(path.name)
    assert "collectives.py" in seen and "ring_attention.py" in seen


def test_build_module_imports_without_nvcc():
    code = ("import repro_torch.kernels.build as b, repro_torch.kernels.ops\n"
            "print(b.build_dir().name)")
    out = _run(code, PATH="", CUDA_HOME="/nonexistent")
    assert out.returncode == 0, out.stderr
    assert len(out.stdout.strip()) == 16  # the source hash names the build


def test_missing_nvcc_is_a_clear_error(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_build_hash_follows_the_sources(monkeypatch):
    before = build.source_hash()
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-lineinfo"])
    assert build.source_hash() != before
    default = build.REPO_ROOT / "build" / "repro_torch"
    assert build.build_dir().parent == default
    monkeypatch.setenv(build.BUILD_ENV, "elsewhere")  # nothing is created
    assert build.build_dir().parent == pathlib.Path("elsewhere")


@pytest.mark.parametrize("op", ["covariance", "jacobi_sweep",
                                "mm_engine_matmul", "dle_find_pivot",
                                "cordic_rotate", "flash_attention",
                                "mamba_scan"])
def test_cuda_backend_on_a_cpu_tensor_raises(op):
    x = torch.ones(4, 4)
    pairs = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    before = launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        if op == "covariance":
            tops.covariance(x, backend="cuda")
        elif op == "jacobi_sweep":
            tops.jacobi_sweep(x, torch.eye(4), pairs, backend="cuda")
        elif op == "mm_engine_matmul":
            tops.mm_engine_matmul(x, x, backend="cuda")
        elif op == "dle_find_pivot":
            tops.dle_find_pivot(x, backend="cuda")
        elif op == "cordic_rotate":
            tops.cordic_rotate(x[0], x[1], x[2], backend="cuda")
        elif op == "flash_attention":
            tops.flash_attention(x[None], x[None], x[None], backend="cuda")
        else:
            u = x[None]
            tops.mamba_scan(u, u, x, u, u, x[0], backend="cuda")
    assert launch_counts() == before


def test_cuda_config_on_cpu_data_raises():
    cfg = tpca.PCAConfig(fused=True, backend="cuda", sweeps=2)
    with pytest.raises(ValueError, match="CUDA"):
        tpca.fit(torch.ones(8, 4), cfg)


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    from repro_torch.kernels import fused, mm_engine
    x = torch.randn(6, 4)
    before = launch_counts()
    np.testing.assert_allclose(fused.fused_covariance(x), x.T @ x, rtol=1e-6)
    np.testing.assert_allclose(mm_engine.mm_engine(x, x.T), x @ x.T,
                               rtol=1e-6)
    assert launch_counts() == before  # the plain version is no launch
    with pytest.raises(ValueError, match="CUDA"):
        mm_engine.mm_engine(torch.ones(2, 2, device="meta"),
                            torch.ones(2, 2, device="meta"))


def _plain_cases():
    """(wrapper, its plain version, arguments) for each standalone kernel."""
    from repro_torch.kernels import cordic, dle, flash_attention, mamba_scan
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g)

    c = randn(9, 9)
    piv = (randn(7), randn(7), randn(7))
    qkv = (randn(2, 5, 8), randn(2, 7, 8), randn(2, 7, 8))
    scan = (randn(1, 6, 4), torch.rand(1, 6, 4, generator=g) * 0.2,
            -torch.rand(4, 3, generator=g), randn(1, 6, 3), randn(1, 6, 3),
            randn(4))
    return {
        "dle_find_pivot": (lambda: dle.dle_scan(c, 4),
                           lambda: ref.dle_scan(c, 4), (c,)),
        "cordic_rotate": (lambda: cordic.cordic_rotation_params(*piv),
                          lambda: ref.cordic_rotation_params_q29(*piv), piv),
        "flash_attention": (
            lambda: flash_attention.flash_attention(*qkv, q_offset=2),
            lambda: ref.flash_attention(*qkv, q_offset=2), qkv),
        "mamba_scan": (lambda: mamba_scan.mamba_scan(*scan),
                       lambda: ref.mamba_scan(*scan), scan),
    }


@pytest.mark.parametrize("op", ["dle_find_pivot", "cordic_rotate",
                                "flash_attention", "mamba_scan"])
def test_standalone_wrapper_takes_its_plain_version_only_on_the_cpu(op):
    from repro_torch.kernels import cordic, dle, flash_attention, mamba_scan
    wrapper, plain, args = _plain_cases()[op]
    before = launch_counts()
    got, want = wrapper(), plain()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert bool((g == w).all())
    assert launch_counts() == before  # the plain version is no launch
    meta = [t.to("meta") for t in args]
    fn = {"dle_find_pivot": lambda: dle.dle_scan(*meta),
          "cordic_rotate": lambda: cordic.cordic_rotation_params(*meta),
          "flash_attention": lambda: flash_attention.flash_attention(*meta),
          "mamba_scan": lambda: mamba_scan.mamba_scan(*meta)}[op]
    if op in ("flash_attention", "mamba_scan"):
        # the dry run's meta tensors take the fake branch: the launch's
        # outputs, no launch
        got = fn()
        assert (got.device.type, got.shape, got.dtype) == (
            "meta", want.shape, want.dtype)
        assert launch_counts() == before
        return
    with pytest.raises(ValueError, match="CUDA"):
        fn()


@pytest.mark.parametrize("entry", ["fit", "fit_transform", "eigh_batched",
                                   "pca_batched"])
def test_device_cuda_without_a_card_raises(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.ones((8, 4), np.float32)
    with pytest.raises(RuntimeError, match="is_available"):
        if entry == "fit":
            tpca.fit(X)  # numpy input defaults to the card
        elif entry == "fit_transform":
            tpca.fit_transform(X, 2, device="cuda")
        elif entry == "eigh_batched":
            tsolver.jacobi_eigh_batched(np.zeros((1, 4, 4), np.float32))
        else:
            tsolver.pca_fit_batched(np.zeros((1, 8, 4), np.float32),
                                    device="cuda")


def test_tensor_keeps_its_device():
    t = torch.ones(3)
    assert _device.as_tensor(t) is t
    assert _device.as_tensor(np.ones(3), "cpu").device.type == "cpu"


def test_registry_resolution_order(monkeypatch):
    cpu = torch.ones(2)
    assert registry.default_backend(cpu) == "torch"
    assert registry.backends_for("covariance") == ("cuda", "torch")
    monkeypatch.setenv(registry.ENV_VAR, "cuda")
    assert registry.default_backend(cpu) == "cuda"
    with registry.use_backend("torch"):
        assert registry.default_backend(cpu) == "torch"
    monkeypatch.setenv(registry.ENV_VAR, "tpu")
    with pytest.raises(ValueError):
        registry.default_backend(cpu)
    monkeypatch.delenv(registry.ENV_VAR)
    registry.reset_resolution_counts()
    tops.mm_engine_matmul(cpu[:, None], cpu[None, :])
    assert registry.resolution_counts() == {("mm_engine_matmul", "torch"): 1}
    assert "mm_engine_matmul" in registry.describe()


def test_kernel_records_name_their_sources():
    root = SRC.parent
    for k in KERNELS:
        assert (root / k.source).is_file(), k.source
        path, line = k.replaces.split(":")
        text = (root / path).read_text().splitlines()
        assert "pallas_call" in text[int(line) - 1], k.replaces
