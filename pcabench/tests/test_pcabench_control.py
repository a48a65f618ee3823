"""The control -- the float64 reference computed one precision below the
configuration's, at TF32, in the program's place -- fails each cell's
limits; the program's plain versions pass them.  On the CPU at a size a
test run holds; the same on the card at the cells' own sizes."""
import json

import pytest
import torch

import small
from pcabench import harness
from pcabench.reference import compare

CELLS = ["fit.mnist-28x28", "serve.mixed", "serve.small"]


def control_numbers(cell):
    driver = harness.load_module("drivers", cell.traffic["driver"])
    readings = driver.control(cell, driver.inputs(cell))
    return compare.numbers(cell.config["checks"], readings)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 7])
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits(workload, seed):
    nums = control_numbers(small.small_cell(workload, seed))
    assert not compare.passed(nums), nums


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells' own sizes")
    bench = json.loads((small.ROOT / "BENCHMARK.json").read_text())
    cell = harness.resolve(bench, workload, 2 ** 31 + 17)
    cell.device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    nums = control_numbers(cell)
    assert not compare.passed(nums), nums
