"""Driver ``serve_closed``: a closed loop of clients over one
``repro_torch.serving.PCAServer``; each client submits its next request
when its last one is done.

Traffic parameters: ``clients``; ``pool`` (``reference.data.pool_shapes``:
the requests' ops and widths, drawn with the pool's own ``shape_seed``, so
every run seed serves the same sizes); ``check_keep`` (the share of
sequence positions whose answers are kept for the judge, drawn from the
seed). Set-up ends with a closed loop of ``WARM_S`` seconds, after one
flush of every (op, bucket) key of the pool: it fills the allocators'
caches as the window will; then the objects of set-up are moved out of
the garbage collector's reach (``gc.freeze``). At most ``CHECK_PER_OP``
kept answers of each op are judged, drawn again from the seed. The
configuration gives the solver (``solver``) and the server (``server``).

The requests are numpy arrays made on the card from the seed and copied to
the host in set-up. The window submits them in one order drawn with the
pool's ``shape_seed``, from the start, cycling: every run seed sends the
same sizes in the same order, and the seed changes only the data (which
changes no solve's time: the sweeps are a fixed schedule). A request's
latency runs on the benchmark's clock from its ``submit`` call until the
loop sees its ticket done (its result on the host). ``--seconds`` after
the first submit the clients stop submitting, and the loop polls on until
every request sent has come back; the window closes then, on the clock
read after that wait. ``requests_per_s`` counts every request of the
window over all of its time, ``latency_p95_ms`` is their 95th percentile:
no request is cut off half served, so the count does not jump by the
requests that one poll retires together. An answer still out ``GRACE_S``
after ``--seconds`` is waited for by a drain; one that never comes is
``missing``.
"""
from __future__ import annotations

import gc
import time
import warnings

import numpy as np
import torch

from pcabench import counts, tracing
from pcabench.harness import Measured
from pcabench.reference import compare, data, plain

IDLE_S = 1e-4  # the loop's sleep when a poll retired nothing
WARM_S = 2.0  # the closed loop that ends set-up
CHECK_PER_OP = 256  # kept answers of each op judged
GRACE_S = 60.0  # the wait past --seconds before the loop drains the server


def make_server(cell):
    """The configuration's ``PCAServer`` on the cell's device."""
    from repro_torch.core.pca import PCAConfig
    from repro_torch.serving import BucketPolicy, PCAServer
    from repro_torch.serving.sharded import LocalExecutor
    s = cell.config["server"]
    with warnings.catch_warnings():  # the kwargs shim's DeprecationWarning
        warnings.simplefilter("ignore", DeprecationWarning)
        return PCAServer(
            PCAConfig(**cell.config["solver"]),
            policy=BucketPolicy(**s["policy"]), max_batch=s["max_batch"],
            max_delay_s=s["max_delay_s"], pad_batches=s["pad_batches"],
            executor=LocalExecutor(device=cell.device),
            max_inflight=s["max_inflight"], cache_dir=s["cache_dir"])


class Loop:
    """The clients, each with at most one request outstanding.  The answers
    of the sequence positions ``keep`` marks are copied out for the judge;
    the rest are dropped as they come, so that the window holds no host
    memory a user's loop would not."""

    def __init__(self, server, requests, mats, order, clients: int, keep,
                 rec):
        self.server, self.requests, self.mats = server, requests, mats
        self.order, self.clients = order, clients
        self.keep, self.rec = keep, rec

    def run(self, seconds: float, window: bool = False) -> dict:
        server, rec, keep = self.server, self.rec, self.keep
        pos = 0
        outstanding = {}
        done = []   # (item, t_submit, t_done, queue_s)
        kept = []   # (item, {field: array})

        def submit(client):
            nonlocal pos
            item = int(self.order[pos % len(self.order)])
            t = time.perf_counter()
            with rec.span("pcabench.submit"):
                ticket = server.submit(self.mats[item],
                                       op=self.requests[item].op)
            outstanding[client] = (ticket, t, item, pos)
            pos += 1

        def collect(now, more: bool):
            for client, (ticket, t, item, at) in list(outstanding.items()):
                if ticket.done:
                    del outstanding[client]
                    done.append((item, t, now, ticket.record.queue_s))
                    if keep[at % len(keep)]:
                        res = ticket.result()
                        kept.append((item, {
                            f: np.array(getattr(res, f)) for f in
                            compare.FIELDS[self.requests[item].op]}))
                    if more:
                        submit(client)

        with rec.span(tracing.WINDOW if window else "pcabench.warm"):
            t0 = time.perf_counter()
            end = t0 + seconds
            for client in range(self.clients):
                submit(client)
            seen = -1
            while outstanding:
                now = time.perf_counter()
                if now >= end + GRACE_S:
                    break
                with rec.span("pcabench.poll"):
                    server.poll()
                if server.stats.flushes != seen:
                    seen = server.stats.flushes
                    now = time.perf_counter()
                    collect(now, now < end)
                else:
                    time.sleep(IDLE_S)
            if outstanding:
                with rec.span("pcabench.drain"):
                    server.drain()
                collect(time.perf_counter(), False)
            t_close = time.perf_counter()
        from repro_torch.kernels import launch_counts
        return {"t0": t0, "t_close": t_close, "done": done, "kept": kept,
                "attempted": pos, "missing": len(outstanding),
                "flushes": list(server.stats.flush_records),
                "launches": launch_counts()}


def inputs(cell) -> dict:
    """The request pool: (op, shape) and a numpy matrix a request."""
    requests = data.pool_shapes(cell.traffic["pool"])
    gen = data.generator(cell.seed, cell.device)
    return {"requests": requests,
            "mats": data.pool_data(requests, gen, cell.device)}


def prepare(cell) -> dict:
    tr = cell.traffic
    pool = inputs(cell)
    requests, mats = pool["requests"], pool["mats"]
    cell.stamp("inputs")
    order = np.random.default_rng(int(tr["pool"]["shape_seed"])).permutation(
        len(requests))
    server = make_server(cell)
    cell.stamp("program")
    first = {}
    for i in order:
        key = (requests[i].op, server.policy.bucket_shape(requests[i].shape))
        first.setdefault(key, int(i))
    for (op, _), i in sorted(first.items()):
        server.submit(mats[i], op=op)
        server.drain()
    cell.stamp("keys")
    keep = np.random.default_rng((cell.seed + 2) % (1 << 64)).random(
        1 << 20) < float(tr["check_keep"])
    loop = Loop(server, requests, mats, order, int(tr["clients"]),
                keep, tracing.Recorder(False))
    loop.run(WARM_S)
    if cell.device.type == "cuda":
        torch.cuda.synchronize(cell.device)
    cell.stamp("warm")
    server.stats.reset()
    # as a long-lived server process does once warm: the heap of set-up
    # (torch's modules, the pool) goes to the collector's permanent
    # generation, so that a full collection in the window scans only what
    # the window makes, not some 0.2 s of objects with the card left idle
    gc.collect()
    gc.freeze()
    return {"server": server, "loop": loop, "requests": requests,
            "mats": mats}


def measure(cell, state: dict, seconds: float, rec) -> Measured:
    from repro_torch.kernels import reset_launch_counts
    loop = state["loop"]
    loop.rec = rec
    reset_launch_counts()
    out = loop.run(seconds, window=True)
    window_s = out["t_close"] - out["t0"]
    done = out["done"]
    lat = np.asarray([d[2] - d[1] for d in done])
    sweeps = state["server"].config.sweeps
    requests = state["requests"]
    return Measured(
        t0=out["t0"],
        e2e={"requests_per_s": len(done) / window_s,
             "latency_p95_ms": float(np.percentile(lat, 95)) * 1e3
             if len(lat) else float("nan")},
        window_s=window_s, attempted=out["attempted"],
        missing=out["missing"],
        layer={"launches": out["launches"], "flushes": out["flushes"],
               "queue_s": [d[3] for d in done],
               "flops": sum(counts.request_flops(
                   requests[d[0]].op, requests[d[0]].shape, sweeps)
                   for d in done)},
        answers=out["kept"])


def release(state: dict) -> dict:
    """The inputs, for the reference; the server and its solvers go."""
    state.pop("server")
    state.pop("loop")
    return {"requests": state["requests"], "mats": state["mats"]}


def judge(cell, inputs: dict, answers) -> list:
    """The kept answers (``check_keep`` of the sequence positions, drawn
    from the seed), at most ``CHECK_PER_OP`` of each op drawn again from
    the seed, against the float64 reference of their inputs."""
    requests, mats = inputs["requests"], inputs["mats"]
    rng = np.random.default_rng((cell.seed + 1) % (1 << 64))
    picked = []
    for op in ("eigh", "svd", "pca"):
        mine = [a for a in answers if requests[a[0]].op == op]
        if len(mine) > CHECK_PER_OP:
            mine = [mine[i] for i in sorted(
                rng.choice(len(mine), CHECK_PER_OP, replace=False))]
        picked += mine
    refs = {}
    readings = []
    for item, answer in picked:
        op = requests[item].op
        if item not in refs:
            refs[item] = plain.request_reference(
                op, torch.as_tensor(mats[item], device=cell.device))
        readings.append((op, compare.request_parts(op, answer, refs[item])))
    return readings


def control(cell, inputs: dict) -> list:
    """The TF32 control in the program's place: every request of the pool
    answered once, judged as the program's answers are."""
    readings = []
    for r, a in zip(inputs["requests"], inputs["mats"]):
        x = torch.as_tensor(a, device=cell.device)
        answer = plain.tf32_request(r.op, x)
        readings.append((r.op, compare.request_parts(
            r.op, answer, plain.request_reference(r.op, x))))
    return readings
