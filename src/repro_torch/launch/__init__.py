"""repro_torch.launch -- command-line entry points of the port
(``serve_pca``: the PCA/SVD serving CLI; ``serve``: the LM serving CLI)."""
