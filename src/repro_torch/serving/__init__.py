"""repro_torch.serving -- batched multi-tenant PCA/SVD serving (port of
``repro.serving``).

Heterogeneous requests are padded into T-multiple shape buckets
(``batching``), up to S same-bucket requests stack into one batched solve
(``solver``), and ``engine.PCAServer`` runs the queue with deadline-aware
microbatching, a two-tier solver cache (``cache``: a bounded in-memory LRU
keyed by ``SolverKey``, and with ``cache_dir`` the persistent tier: one
record a CUDA graph of an (op, bucket, batch) key, and the kernel library,
from which a fresh replica warms with no nvcc run) and telemetry
(``stats``).  Flush placement is an executor
(``sharded.LocalExecutor``: one device, ``cuda`` by default;
``sharded.MeshExecutor``: the flush's batch sharded over a device mesh,
``host_mesh`` the 1-D mesh over the visible cards); flush timing
is a pipeline (``inflight``): the executor launches without blocking the
host, a bounded in-flight queue holds launched flushes, each with a CUDA
event as its completion signal, and retirement gathers each flush to the
host in one copy -- ``PCAServer(max_inflight=N)`` overlaps host-side
batching with the card's sweeps (N=1 is the synchronous engine).

The control plane is the reference's: the (policy, T, pow2 cap, S,
inflight, executor) tuple is a ``ServingPlan`` that ``autotune`` searches
from a captured ``TrafficProfile`` and ``PCAServer.apply_plan`` hot-swaps
onto a live server (on the server's own device); one frozen
``spec.ServerSpec`` builds the whole stack (``PCAServer.from_spec`` /
``build_server``, with ``device=``); ``controller.ServingController``
re-profiles a sliding telemetry window and hot-swaps behind hysteresis and
dwell guards; ``frontend.TrafficFrontend`` drives a server with open-loop
multi-tenant arrivals through WFQ and admission control.
"""
from .autotune import (AutotuneResult, CostModel, ServingPlan,
                       TrafficProfile, TRACE_KINDS, autotune, bandit_search,
                       plan_grid, replay, server_for_plan, solve_work,
                       subsample, synthetic_trace, trace_dims)
from .batching import (BucketPolicy, POLICIES, pad_to_bucket, padding_waste,
                       stack_requests)
from .cache import (DiskCache, ExecutableCache, LRUCache, SolverKey,
                    aot_supported, content_hash, environment_fingerprint)
from .controller import ServingController
from .engine import (BackendRouter, OPS, PCAServer, ServedEigh, ServedPCA,
                     ServedSVD, Ticket, threshold_router)
from .frontend import (ADMISSION_MODES, ARRIVALS, AdmissionController,
                       AdmissionDecision, Arrival, FairQueue,
                       FrontendReport, SCHEDULERS, TenantSpec, TokenBucket,
                       TrafficFrontend, VirtualClock, arrival_times,
                       generate, materialize, merge, parse_tenants,
                       profile_of)
from .inflight import InFlightFlush, InFlightQueue
from .sharded import LocalExecutor, MeshExecutor, host_mesh, mesh_executor
from .spec import (CacheSpec, ControllerSpec, ExecutionSpec, ObsSpec,
                   SchedulingSpec, ServerSpec, SpecConflictError,
                   build_server, resolve_spec, validate_args)
from .solver import (BatchedEighResult, BatchedPCAResult, BatchedSVDResult,
                     build_solver_fn, jacobi_eigh_batched,
                     jacobi_svd_batched, pca_fit_batched,
                     pca_transform_batched)
from .stats import FlushRecord, RequestRecord, ServingStats, percentile

__all__ = [
    "ADMISSION_MODES", "ARRIVALS", "AdmissionController",
    "AdmissionDecision", "Arrival", "FairQueue", "FrontendReport",
    "SCHEDULERS", "TenantSpec", "TokenBucket", "TrafficFrontend",
    "VirtualClock", "arrival_times", "generate", "materialize", "merge",
    "parse_tenants", "profile_of",
    "AutotuneResult", "BackendRouter", "BatchedEighResult",
    "BatchedPCAResult", "BatchedSVDResult", "BucketPolicy", "CacheSpec",
    "ControllerSpec", "CostModel", "DiskCache", "ExecutableCache",
    "ExecutionSpec", "FlushRecord", "InFlightFlush", "InFlightQueue",
    "LRUCache", "LocalExecutor", "MeshExecutor", "OPS", "ObsSpec",
    "PCAServer", "POLICIES", "RequestRecord", "SchedulingSpec",
    "ServedEigh", "ServedPCA", "ServedSVD", "ServerSpec",
    "ServingController", "ServingPlan", "ServingStats", "SolverKey",
    "SpecConflictError", "Ticket", "TrafficProfile", "TRACE_KINDS",
    "aot_supported", "autotune", "bandit_search", "build_server",
    "build_solver_fn", "content_hash", "environment_fingerprint",
    "host_mesh",
    "jacobi_eigh_batched", "jacobi_svd_batched",
    "mesh_executor", "pad_to_bucket", "padding_waste", "pca_fit_batched",
    "pca_transform_batched", "percentile", "plan_grid", "replay",
    "resolve_spec", "server_for_plan", "solve_work", "stack_requests",
    "subsample", "synthetic_trace", "threshold_router", "trace_dims",
    "validate_args",
]
