"""Serving layer of the port: bucket padding (``batching``) and the batched
solvers (``solver``).  The serving engine itself is not ported yet."""
from .batching import (BucketPolicy, pad_to_bucket, padding_waste,
                       stack_requests)
from .solver import (BatchedEighResult, BatchedPCAResult, BatchedSVDResult,
                     build_solver_fn, jacobi_eigh_batched, jacobi_svd_batched,
                     pca_fit_batched, pca_transform_batched)

__all__ = ["BucketPolicy", "pad_to_bucket", "padding_waste", "stack_requests",
           "BatchedEighResult", "BatchedPCAResult", "BatchedSVDResult",
           "build_solver_fn", "jacobi_eigh_batched", "jacobi_svd_batched",
           "pca_fit_batched", "pca_transform_batched"]
