#!/usr/bin/env python
"""The CORDIC kernel of several source trees in turns, on one CUDA card:

    python scripts/cordic_ab.py TREE [TREE ...]

Run from the repository root (it imports ``scripts/kernel_ab.py``).  Each
TREE holds ``src/repro_torch`` (``.``, or a version unpacked with ``git
archive`` into a gitignored directory); the trees are built first, all at
once, then each runs in a process of its own, in the order given.  For
k = 392 (one round's pivots at n = 784) and 2^20 seeded pivots: whether
``cordic.cordic_rotation_params`` is bitwise its plain version, its
device time a call (``torch.profiler``, 200 calls) and its time between
back-to-back calls (CUDA events, 500 calls); then the kernel's SASS
chain (``kernel_ab.sass_chain``: dependent instructions, cycles,
instructions) and opcodes.  One JSON line a tree."""
import json
import subprocess
import sys

sys.path.insert(0, "scripts")
import kernel_ab as ka  # noqa: E402


def one(tree):
    ka.use_tree(tree)
    import torch
    from repro_torch.kernels import build, cordic, ref
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"tree": tree}
    for k in (392, 1 << 20):
        scale = 10.0 ** torch.randint(-3, 4, (3, k), generator=g, device=dev)
        piv = tuple((torch.randn(3, k, generator=g, device=dev) * scale)
                    .contiguous())
        got = cordic.cordic_rotation_params(*piv)
        want = ref.cordic_rotation_params_q29(*piv)
        out[k] = {"bitwise": all(torch.equal(a, b) for a, b in zip(got, want)),
                  "device_ms": ka.traced(
                      lambda: cordic.cordic_rotation_params(*piv),
                      200)["device_ms"],
                  "ms": ka.time_ms(lambda: cordic.cordic_rotation_params(*piv),
                                   500)}
    c = ka.sass_chain(str(build.build_dir() / build.LIB_NAME), "cordic_kernel")
    out["chain"] = [c["chain_instructions"], c["chain_cycles"],
                    c["instructions"]]
    out["opcodes"] = dict(sorted(c["opcodes"].items(), key=lambda kv: -kv[1]))
    print(json.dumps(out), flush=True)


if len(sys.argv) == 3 and sys.argv[1] == "--one":
    one(sys.argv[2])
    sys.exit(0)
trees = sys.argv[1:]
builds = [subprocess.Popen([sys.executable, "scripts/kernel_ab.py", "--build",
                            t]) for t in dict.fromkeys(trees)]
assert not any(p.wait() for p in builds)
for t in trees:
    subprocess.run([sys.executable, __file__, "--one", t], check=True)
