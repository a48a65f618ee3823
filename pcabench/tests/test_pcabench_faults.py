"""A run with its timed path broken underneath comes out not correct.

Each case drives the rest of a run on the CPU (``harness.run_cell`` on a
cell cut to CPU size, past the look for a card) with one fault planted in
the program: a sweep that returns its state unchanged; half of the rows
left out of the Gram, the mean taken over the rest; half of a flush's live
problems left out (zeroed); an answer altered where it is produced. One
chip, so no exchange between chips to leave out.
"""
import time

import numpy as np
import pytest
import torch

import small
from pcabench import harness

CELLS = ["fit.mnist-28x28", "serve.mixed", "serve.small"]


def run(workload, seed=11):
    out = harness.run_cell(small.small_cell(workload, seed), 0.5, False,
                           time.perf_counter())
    return out["result"]


def sweep_unchanged(monkeypatch):
    from repro_torch.kernels import ref
    monkeypatch.setattr(ref, "jacobi_sweep_step",
                        lambda C, V, pairs, angle="rutishauser":
                        (C.clone(), V.clone()))


def half_rows(monkeypatch):
    from repro_torch.kernels import ref
    gram = ref.covariance_gram

    def half(x, **kw):
        return 2.0 * gram(x[..., : x.shape[-2] // 2, :].contiguous(), **kw)
    monkeypatch.setattr(ref, "covariance_gram", half)


def half_batch(monkeypatch):
    from repro_torch.serving.sharded import LocalExecutor
    submit = LocalExecutor.submit

    def half(self, fn, batch, n_active):
        live = int((n_active[0] > 0).sum())
        batch = batch.copy()
        batch[live // 2:live] = 0.0
        return submit(self, fn, batch, n_active)
    monkeypatch.setattr(LocalExecutor, "submit", half)


def alter(a):
    """``a`` with its first entry moved by 1% of its largest magnitude."""
    a = a.clone() if isinstance(a, torch.Tensor) else np.array(a)
    a.reshape(-1)[0] += 0.01 * float(abs(a).max())
    return a


def answer_altered(monkeypatch):
    import dataclasses

    from repro_torch.core import pca
    from repro_torch.serving import engine
    transform = pca.transform
    monkeypatch.setattr(pca, "transform",
                        lambda *a, **kw: alter(transform(*a, **kw)))
    unpack = engine.PCAServer._unpack

    def altered(op, out, i, shape):
        res = unpack(op, out, i, shape)
        first = dataclasses.fields(res)[0].name
        return dataclasses.replace(res, **{first: alter(getattr(res, first))})
    monkeypatch.setattr(engine.PCAServer, "_unpack", staticmethod(altered))


FAULTS = {"sweep_unchanged": sweep_unchanged, "half_rows": half_rows,
          "half_batch": half_batch, "answer_altered": answer_altered}


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    res = run(workload)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(workload, fault, monkeypatch):
    if fault == "half_batch" and workload.startswith("fit"):
        pytest.skip("a fit has no batch of problems")
    FAULTS[fault](monkeypatch)
    res = run(workload)
    assert not res["correct"], res["checks"]
