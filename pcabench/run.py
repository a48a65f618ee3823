"""Run one cell of the benchmark of the PyTorch/CUDA port.

    python3 pcabench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Prints the result as one JSON line, the last
of standard output; the numbers compared with the reference, each beside
its limit, are the last lines of standard error.  Exits 2 without a result
where the cell cannot run (no card, too few cards, an unknown name), and 3
where a module of JAX or of the JAX package was loaded.
"""
import pathlib
import sys
import time

T_START = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from pcabench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
