"""The two packages of the control-plane parity tests side by side.

``PKGS["ref"]`` is the JAX reference (``repro``), ``PKGS["port"]`` the
PyTorch port (``repro_torch``) on the CPU.  Each ``Pkg`` carries the
modules a test body needs and builds servers the package's own way: the
port's entry points are given ``device="cpu"`` (their default is the
card), the reference's take no device.  A test body written against a
``Pkg`` runs once per package, so each case counts once per package.
"""
from __future__ import annotations

import importlib
import types
import warnings


class Pkg(types.SimpleNamespace):
    """One package's control-plane modules and constructors."""

    def server(self, config=None, **kw):
        """``PCAServer(config, **kw)``; the port's on the CPU (the executor
        is one kwarg more, so the port silences the deprecation shim's
        warning that the reference would not raise for ``kw``)."""
        config = config or self.PCAConfig()
        if self.name == "ref":
            return self.serving.PCAServer(config, **kw)
        kw.setdefault("executor", self.serving.LocalExecutor(device="cpu"))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return self.serving.PCAServer(config, **kw)

    def build_server(self, spec, **kw):
        return self.serving.build_server(spec, **kw, **self.dev)

    def from_spec(self, spec, **kw):
        return self.serving.PCAServer.from_spec(spec, **kw, **self.dev)

    def server_for_plan(self, plan, config=None, **kw):
        return self.serving.server_for_plan(plan, config, **kw, **self.dev)

    def autotune(self, profile, **kw):
        return self.serving.autotune(profile, **kw, **self.dev)

    def bandit_search(self, profile, **kw):
        return self.serving.bandit_search(profile, **kw, **self.dev)

    def main(self, argv):
        return self.serve_pca.main(argv, **self.dev)


def _load(name: str) -> Pkg:
    root = {"ref": "repro", "port": "repro_torch"}[name]
    mod = lambda path: importlib.import_module(f"{root}.{path}")  # noqa: E731
    return Pkg(
        name=name,
        dev={} if name == "ref" else {"device": "cpu"},
        plain_backend="ref" if name == "ref" else "torch",
        PCAConfig=mod("core.pca").PCAConfig,
        obs=mod("obs"),
        serving=mod("serving"),
        autotune_mod=mod("serving.autotune"),
        stats=mod("serving.stats"),
        backends=mod("backends"),
        serve_pca=mod("launch.serve_pca"),
    )


class _Pkgs(dict):
    def __missing__(self, name):
        pkg = self[name] = _load(name)
        return pkg


PKGS = _Pkgs()
NAMES = ("ref", "port")
