"""repro_torch.launch -- command-line entry points of the port
(``serve_pca``: the PCA/SVD serving CLI; ``serve``: the LM serving CLI;
``train``: the trainer CLI) and what they build on (``steps``, the
train, prefill and serve steps; ``accounting``, parameter and FLOP
counts)."""
