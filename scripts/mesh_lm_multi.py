"""The LM half of multi-device across every visible card: phase 13's
multi-card leg of ``chip_smoke.py`` (olmo-1b at ``--model-parallel 2``
for 2 steps, one process a card) beside a one-card run of the same argv,
then the serve CLI under torchrun at ``--model-parallel N`` (N the
visible cards) beside one card's tokens, then phase 14's pod leg: the
cross-pod gradient exchange at ``--mesh 2,N/2,1`` on N cards (N even),
one process a card under torchrun, each mode's bytes a rank against
those that the leaves' sizes give.  On a host with two cards or more:

    python3 scripts/mesh_lm_multi.py
"""
import contextlib
import io
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    from repro_torch.kernels import build
    from repro_torch.launch import serve, train
    build.library()
    cs.log(cs.nvidia_smi())
    dev = torch.device("cuda", 0)
    torch.use_deterministic_algorithms(True, warn_only=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        losses = train.main(cs.train_argv(
            cs.TRAIN_STEPS, "--preempt-at", str(cs.MESH_MULTI_STEPS)),
            device=dev)
    cs.log(f"one card: losses {json.dumps(losses)} in "
           f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    multi = cs.mesh_multi({"losses": losses})
    cs.log(f"multi: {json.dumps(multi)} in {time.perf_counter() - t0:.1f} s")

    argv = ["--arch", "olmo-1b", "--batch", "4", "--prompt-len", "4096",
            "--gen-len", "32", "--seed", "0"]
    with contextlib.redirect_stdout(io.StringIO()):
        one = serve.main(argv, device=dev)
    torch.cuda.empty_cache()
    n = torch.cuda.device_count()
    out = ROOT / "build" / "multi_serve_tokens.json"
    script = ROOT / "build" / "multi_serve.py"
    script.write_text(f"""
import json, sys
sys.path.insert(0, {str(ROOT / 'src')!r})
import torch.distributed as dist
from repro_torch.launch import serve
toks = serve.main({argv + ['--model-parallel', str(n)]!r})
if dist.get_rank() == 0:
    open({str(out)!r}, "w").write(json.dumps(toks.tolist()))
dist.destroy_process_group()
""")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                        "--nproc-per-node", str(n), str(script)],
                       capture_output=True, text=True, timeout=600)
    cs.log(f"torchrun serve --model-parallel {n}: rc {r.returncode} in "
           f"{time.perf_counter() - t0:.1f} s; {r.stdout[-1500:]} "
           f"{r.stderr[-3000:]}")
    toks = np.asarray(json.loads(out.read_text()))
    cs.log(f"serve tokens at --model-parallel {n} equal to one card's: "
           f"share {float(np.mean(toks == one))}; row 0 "
           f"{toks[0][:16].tolist()} against {one[0][:16].tolist()}")
    t0 = time.perf_counter()
    pod = cs.pod_multi(cs.nvidia_smi())
    pod.pop("record", None)
    cs.log(f"pod: {json.dumps(pod)} in {time.perf_counter() - t0:.1f} s")
    return r.returncode


if __name__ == "__main__":
    sys.exit(main())
