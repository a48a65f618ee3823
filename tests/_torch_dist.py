"""Spawn a gloo world of N processes on the CPU for the port's multi-rank
tests.

``run_world(n, case, tmp_path, **kw)`` starts n Python processes, each
joining a ``FileStore`` in ``tmp_path`` as rank r of n, with
``torch.set_num_threads(1)`` (the suite runs under ``pytest -n 6``), and
runs ``_torch_dist_cases.<case>(rank, world, tmp_path, **kw)`` there.
The children import only ``torch``, ``numpy`` and the port (they are
started with ``python -c``, not forked from the test process, so nothing
the parent imported leaks in: ``_torch_dist_cases`` asserts that JAX and
the reference are absent).  Rank 0's return value, a JSON document, is
returned; numpy inputs and outputs travel as ``.npz`` files in
``tmp_path``.  Each world has a 240 s timeout and is killed past it.
"""
import json
import os
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"
TIMEOUT = 240

_CHILD = """
import json, sys, torch
torch.set_num_threads(1)
sys.path[:0] = [{src!r}, {here!r}]
import _torch_dist_cases as cases
out = cases.run({case!r}, {rank}, {world}, {tmp!r}, json.loads({kw!r}))
if {rank} == 0:
    with open({result!r}, "w") as f:
        json.dump(out, f)
"""


def run_world(n: int, case: str, tmp_path, **kw) -> dict:
    tmp = pathlib.Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    result = tmp / f"{case}.result.json"
    store = tmp / f"{case}.store"
    for p in (result, store):
        if p.exists():
            p.unlink()
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = []
    for r in range(n):
        code = _CHILD.format(src=str(SRC), here=str(HERE), case=case,
                             rank=r, world=n, tmp=str(tmp),
                             kw=json.dumps(kw), result=str(result))
        log = open(tmp / f"{case}.rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, "-c", code],
                                       env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + TIMEOUT
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if bad:
        logs = (tmp / f"{case}.rank{bad[0]}.log").read_text()[-6000:]
        raise AssertionError(f"{case}: ranks {bad} failed "
                             f"(codes {[procs[r][0].returncode for r in bad]})"
                             f"\n{logs}")
    return json.loads(result.read_text())
