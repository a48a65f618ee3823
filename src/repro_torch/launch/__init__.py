"""repro_torch.launch -- command-line entry points of the port
(``serve_pca``: the PCA/SVD serving CLI; ``serve``: the LM serving CLI;
``train``: the trainer CLI; ``pod_compression``: the cross-pod
compressed gradient exchange, run as ``python -m
repro_torch.launch.pod_compression`` and not imported here, as the
reference's) and what they build on (``steps``, the train, prefill and
serve steps; ``accounting``, parameter and FLOP counts; ``mesh``, the
production and host meshes)."""
