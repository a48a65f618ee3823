"""In-flight flushes: the pipeline stage between dispatch and retire (port
of ``repro.serving.inflight``).

The serving engine is a three-stage software pipeline:

  dispatch   stack / pad / look up the solver / launch.  Non-blocking: the
             executor stages the batch through pinned memory and enqueues
             every kernel on the card's stream, then the copy of the
             results to the host (``copy_to_host``), so the host goes
             straight back to batching.
  in-flight  a bounded, dispatch-ordered queue of ``InFlightFlush``
             handles.  ``ready()`` is the completion detector (no host
             block); the bound (``PCAServer(max_inflight=...)``) is the
             back-pressure valve.
  retire     wait for the flush's event, unpack its host copy into
             tickets, record telemetry.

``InFlightFlush`` is created by an executor (``sharded.LocalExecutor
.submit``) around the launched result tree, its host copy and a
``torch.cuda.Event`` recorded on the launch stream right after both -- one
of each a shard for ``sharded.MeshExecutor``, whose shards' results are
concatenated in shard order when the flush retires; the
engine then annotates it with its bookkeeping and links ``retire()`` back
to its own retire stage, so a ``Ticket`` can force exactly its own flush
home.  The copy to the host is enqueued at launch, on the launch stream,
right behind the flush's own kernels: a copy enqueued at retire time would
queue behind every younger flush launched since, and the host would wait
for those too.  On the CPU the solve has finished when ``submit``
returns: there is no copy and no event, and ``ready()`` is True.

Retirement is *ordered*: the queue offers flushes oldest-first, while
``retire_ready`` lets later flushes that finished early retire out of
dispatch order -- each flush only fulfils its own tickets.  With
``max_inflight=1`` the pipeline degrades exactly to the synchronous flush.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch


def copy_to_host(out) -> torch.Tensor:
    """Enqueue one device-to-host copy of a result tree (a NamedTuple of
    CUDA tensors) on the current stream, without blocking: the tensors are
    packed into one byte buffer on the device and copied to a pinned host
    buffer, which holds the results once the stream has passed the copy."""
    packed = torch.cat([t.detach().reshape(-1).view(torch.uint8)
                        for t in out])
    host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    return host


def _unpack(out, host: np.ndarray):
    """The NamedTuple ``out`` of tensors as numpy arrays read from the
    packed bytes ``host`` (``copy_to_host``'s layout)."""
    fields, at = [], 0
    for t in out:
        n = t.numel() * t.element_size()
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        fields.append(host[at:at + n].view(dtype).reshape(t.shape))
        at += n
    return type(out)(*fields)


class InFlightFlush:
    """Handle for one dispatched microbatch awaiting retirement.

    Executors construct it around the just-launched result trees (one a
    shard, in shard order), their host copies in flight, the ready events
    and the host buffers the launch copied from (all kept alive until the
    flush retires); the engine attaches its bookkeeping at dispatch time.
    ``result`` waits for the copies, unpacks each once, concatenates the
    shards and releases the buffers.
    """

    __slots__ = ("seq", "key", "entries", "t_dispatch", "t_launched",
                 "backend", "batch_size", "padded_batch", "cache_hit",
                 "inflight_depth", "n_shards", "retired", "span_id",
                 "_outs", "_host", "_copies", "_events", "_staged",
                 "_retire_cb")

    def __init__(self, outs: Sequence, n_shards: int = 1,
                 copies: Sequence[torch.Tensor] = (),
                 events: Sequence[torch.cuda.Event] = (),
                 staged: Sequence[torch.Tensor] = ()):
        self._outs = tuple(outs)      # result trees, one a shard
        self._host = None             # numpy results, unpacked once
        self._copies = tuple(copies)  # pinned host copies in flight (cards)
        self._events = tuple(events)  # each recorded after its shard's copy
        self._staged = tuple(staged)  # pinned inputs of the launch's copies
        self.n_shards = n_shards
        self.retired = False
        # engine bookkeeping, attached by PCAServer at dispatch time
        self.seq = -1
        self.key: Optional[Tuple] = None
        self.entries: Tuple = ()
        self.t_dispatch = 0.0      # dispatch stage began (pre-stack)
        self.t_launched = 0.0      # executor.submit returned (host free)
        self.backend: Optional[str] = None
        self.batch_size = 0
        self.padded_batch = 0      # device batch after padding/rounding
        self.cache_hit = False
        self.inflight_depth = 1
        self.span_id: Optional[int] = None  # reserved flush-span id (obs)
        self._retire_cb: Optional[Callable] = None

    def ready(self) -> bool:
        """Completion detection without blocking the host: every shard's
        event has passed."""
        if self.retired or self._host is not None:
            return True
        return all(e.query() for e in self._events)

    def block_until_ready(self) -> "InFlightFlush":
        """Block until the flush, and its copies to the host, finished."""
        if not self.retired and self._host is None:
            for e in self._events:
                e.synchronize()
        return self

    def result(self):
        """The flush's results as one host tree of numpy arrays (blocks
        until the flush's copies have landed).

        Per-request slicing happens on the host copy (slicing a device
        tensor per ticket is O(batch) copies).  The results are copied out
        of the pinned buffers, which go back to PyTorch's pool with the
        device tensors and the pinned inputs; the shards' trees are
        concatenated along the batch axis in shard order."""
        if self._host is None:
            if not self._copies:
                hosts = [type(out)(*(t.detach().numpy() for t in out))
                         for out in self._outs]
            else:
                self.block_until_ready()
                hosts = [_unpack(out, copy.numpy().copy())
                         for out, copy in zip(self._outs, self._copies)]
            self._host = hosts[0] if len(hosts) == 1 else type(hosts[0])(
                *(np.concatenate(leaves) for leaves in zip(*hosts)))
            self._outs = self._copies = self._events = ()
            self._staged = ()
        return self._host

    def retire(self) -> int:
        """Force this flush through its engine's retire stage.

        Idempotent; returns the number of requests it fulfilled (0 when
        already retired).  Raises if the flush was never attached to an
        engine (executor-level use: call ``result()`` instead).
        """
        if self._retire_cb is None:
            raise RuntimeError(
                "flush is not attached to an engine; use result() for the "
                "raw device batch")
        return self._retire_cb(self)


class InFlightQueue:
    """Dispatch-ordered set of in-flight flushes (the retire stage inbox).

    The engine owns the bound (``max_inflight``); the queue owns ordering
    and the two retirement sweeps: ``retire_ready`` (free -- whatever the
    device already finished, oldest-first) and ``retire_to_depth``
    (blocking back-pressure -- oldest-first until the cap holds).
    """

    def __init__(self):
        self._flushes: List[InFlightFlush] = []

    def __len__(self) -> int:
        return len(self._flushes)

    def __iter__(self):
        return iter(list(self._flushes))

    @property
    def depth(self) -> int:
        return len(self._flushes)

    def requests(self) -> int:
        """Requests riding the currently in-flight flushes."""
        return sum(len(f.entries) for f in self._flushes)

    def push(self, flush: InFlightFlush) -> None:
        self._flushes.append(flush)

    def remove(self, flush: InFlightFlush) -> None:
        self._flushes.remove(flush)

    def oldest(self) -> Optional[InFlightFlush]:
        return self._flushes[0] if self._flushes else None

    def retire_ready(self) -> int:
        """Retire every already-completed flush (non-blocking sweep).

        Oldest-first, but a young finished flush does not wait for an old
        unfinished one -- that is the out-of-order half of the pipeline.
        Returns the number of requests fulfilled.
        """
        done = 0
        for flush in list(self._flushes):
            if flush.ready():
                done += flush.retire()
        return done

    def retire_to_depth(self, depth: int) -> int:
        """Blocking back-pressure: retire oldest-first until at most
        ``depth`` flushes remain in flight.  ``depth=0`` drains the stage.
        Returns the number of requests fulfilled."""
        done = 0
        while len(self._flushes) > depth:
            done += self._flushes[0].retire()
        return done
