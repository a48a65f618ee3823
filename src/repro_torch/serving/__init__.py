"""repro_torch.serving -- batched PCA/SVD serving (port of
``repro.serving``).

Heterogeneous requests are padded into T-multiple shape buckets
(``batching``), up to S same-bucket requests stack into one batched solve
(``solver``), and ``engine.PCAServer`` runs the queue with deadline-aware
microbatching, a solver cache (``cache``: a bounded in-memory LRU keyed by
``SolverKey``) and telemetry (``stats``).  Flush placement is an executor
(``sharded.LocalExecutor``: one device, ``cuda`` by default); flush timing
is a pipeline (``inflight``): the executor launches without blocking the
host, a bounded in-flight queue holds launched flushes, each with a CUDA
event as its completion signal, and retirement gathers each flush to the
host in one copy -- ``PCAServer(max_inflight=N)`` overlaps host-side
batching with the card's sweeps (N=1 is the synchronous engine).

Not ported yet: the persistent executable tier (``DiskCache``), the
multi-device ``MeshExecutor``, and the control plane (``autotune``,
``frontend``, ``controller``, ``spec``; ``PCAServer.from_spec`` raises).
"""
from .batching import (BucketPolicy, POLICIES, pad_to_bucket, padding_waste,
                       stack_requests)
from .cache import (ExecutableCache, LRUCache, SolverKey,
                    environment_fingerprint)
from .engine import (BackendRouter, OPS, PCAServer, ServedEigh, ServedPCA,
                     ServedSVD, Ticket, threshold_router)
from .inflight import InFlightFlush, InFlightQueue
from .sharded import LocalExecutor, mesh_executor
from .solver import (BatchedEighResult, BatchedPCAResult, BatchedSVDResult,
                     build_solver_fn, jacobi_eigh_batched, jacobi_svd_batched,
                     pca_fit_batched, pca_transform_batched)
from .stats import FlushRecord, RequestRecord, ServingStats, percentile

__all__ = [
    "BackendRouter", "BatchedEighResult", "BatchedPCAResult",
    "BatchedSVDResult", "BucketPolicy", "ExecutableCache", "FlushRecord",
    "InFlightFlush", "InFlightQueue", "LRUCache", "LocalExecutor", "OPS",
    "PCAServer", "POLICIES", "RequestRecord", "ServedEigh", "ServedPCA",
    "ServedSVD", "ServingStats", "SolverKey", "Ticket", "build_solver_fn",
    "environment_fingerprint", "jacobi_eigh_batched", "jacobi_svd_batched",
    "mesh_executor", "pad_to_bucket", "padding_waste", "pca_fit_batched",
    "pca_transform_batched", "percentile", "stack_requests",
    "threshold_router",
]
