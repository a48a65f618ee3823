#!/usr/bin/env python
"""chip_smoke.py's phase 16 on the card one family at a time, with two
probes beside it:

    python scripts/train_families_probe.py [ssm hybrid encdec vlm] \
        [--sweep NAME:lr=A,B] [--sweep NAME:steps=N,M]

Builds the kernels, then runs ``train_family`` for each family named
(default: every one of ``FAMILY_RUNS``, none when a sweep is given); a
family that fails is logged
and the next one runs.  Each kept attention call of a family's held step
is also held against float64 attention (``grads64``: the Function's bf16
and fp32 gradients and autograd through the plain fp32 version, each
against the exact gradients, in units of the phase's bound).  A sweep
reruns a family's trainer alone (``run_train``) at each learning rate or
step count given, the rest of its schedule the phase's, and prints
whether its last loss fell below its first.  Needs one card.
"""
import gc
import json
import pathlib
import sys
import time
import traceback

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def attention64(q, k, v, causal: bool, scale: float, q_offset: int):
    """Softmax attention in float64 (no cast inside)."""
    s = torch.matmul(q, k.mT) * scale
    if causal:
        rows = torch.arange(q.shape[-2], device=q.device)[:, None] + q_offset
        cols = torch.arange(k.shape[-2], device=q.device)[None, :]
        s = s.masked_fill(rows < cols, float("-inf"))
    return torch.matmul(torch.softmax(s, dim=-1), v)


def grads64(kept: dict, dev) -> None:
    """For each kept call: the Function's bf16 gradients (g), autograd
    through the plain fp32 version (w32) and through float64 attention
    (e, the exact yardstick): each one's distance from e in units of the
    check's bound (one bf16 ulp + 2e-5 x max |e|), and max |x - e| over
    max |e|."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 11)
    for i, ((q, k, v), kw) in sorted(kept.items()):
        dout = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        args = [t.clone().requires_grad_(True) for t in (q, k, v)]
        got = torch.autograd.grad(ops.flash_attention(*args, **kw), args,
                                  dout)
        a32 = [t.float().requires_grad_(True) for t in (q, k, v)]
        w32 = torch.autograd.grad(ref.flash_attention(
            *a32, causal=kw["causal"], scale=kw["scale"],
            q_offset=kw.get("q_offset", 0)), a32, dout.float())
        del a32
        a64 = [t.double().requires_grad_(True) for t in (q, k, v)]
        e64 = torch.autograd.grad(attention64(
            *a64, kw["causal"], kw["scale"], kw.get("q_offset", 0)), a64,
            dout.double())
        del a64
        from repro_torch.kernels import grad as kgrad
        f32 = kgrad.attention_backward(
            q.float(), k.float(), v.float(), dout.float(),
            causal=kw["causal"], scale=kw["scale"],
            q_offset=kw.get("q_offset", 0), chunk=kw["chunk"])
        rec = {}
        for name, g, w, e, f in zip(("dq", "dk", "dv"), got, w32, e64, f32):
            top = float(e.abs().max())
            for what, x in (("function", g), ("plain32", w),
                            ("function_fp32", f)):
                x64 = x.double()
                slack = cs.bf16_ulp(torch.maximum(
                    x.float().abs(), e.float().abs())).double() \
                    + cs.FA_GRAD_SLACK * top
                ratio = (x64 - e).abs() / slack
                j = int(ratio.argmax())
                rec[f"{name}_{what}"] = {
                    "over": int((ratio > 1).sum()),
                    "worst_ratio": float(ratio.max()),
                    "at": [float(x64.flatten()[j]), float(e.flatten()[j])],
                    "max_err_over_max": float((x64 - e).abs().max()) / top}
            gw = (g.double() - w.double()).abs()
            j = int(gw.argmax())
            rec[f"{name}_function_vs_plain32_at_worst"] = [
                float(g.flatten()[j]), float(w.flatten()[j]),
                float(e.flatten()[j])]
        cs.log(f"grads64 call {i} {list(q.shape)} x {list(k.shape)}: "
               f"{json.dumps(rec)}")
        del got, w32, e64
        torch.cuda.empty_cache()


def sweep(spec: str, dev) -> bool:
    """``NAME:lr=A,B`` or ``NAME:steps=N,M``: the family's trainer at each
    value.  Returns False if a run failed."""
    name, rest = spec.split(":")
    key, values = rest.split("=")
    ok = True
    for value in values.split(","):
        argv = cs.family_argv(name)
        flag = {"lr": "--lr", "steps": "--steps"}[key]
        argv[argv.index(flag) + 1] = value
        steps = cs.TRAIN_STEPS
        if key == "steps":
            cs.TRAIN_STEPS = int(value)
        try:
            run = cs.run_train(f"{name} at {key} {value}", argv, dev,
                               cfg=cs.family_config(name))
            cs.log(f"{name} {key} {value}: last below first "
                   f"{run['losses'][-1] < run['losses'][0]}")
        except Exception:  # noqa: BLE001 - log it, run the next
            traceback.print_exc()
            ok = False
        finally:
            cs.TRAIN_STEPS = steps
        gc.collect()
        torch.cuda.empty_cache()
    return ok


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.log(f"card: {cs.nvidia_smi()}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    cs.log(f"build: {time.perf_counter() - t0:.1f} s")
    args, sweeps = sys.argv[1:], []
    while "--sweep" in args:
        i = args.index("--sweep")
        sweeps.append(args[i + 1])
        del args[i:i + 2]
    names = args or ([] if sweeps else list(cs.FAMILY_RUNS))
    held = cs.attention_grads_held

    def both(kept, dev):
        grads64(kept, dev)
        return held(kept, dev)
    cs.attention_grads_held = both
    failed, summary = [], {}
    t0 = time.perf_counter()
    for name in names:
        try:
            r = cs.train_family(name, dev)
            summary[name] = {k: r[k] for k in ("losses", "step_s", "mfu",
                                               "peak_gb", "drops")}
        except Exception as e:  # noqa: BLE001 - log it, run the next
            traceback.print_exc()
            cs.log(f"FAILED {name}: {e!r}")
            failed.append(name)
        gc.collect()
        torch.cuda.empty_cache()
    failed += [s for s in sweeps if not sweep(s, dev)]
    cs.log(f"probe: {time.perf_counter() - t0:.1f} s; {json.dumps(summary)}"
           f"; failed {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
