"""Optimizer-side PCA consumers of the port (port of ``repro.optim``):
spectral gradient telemetry and PCA gradient compression.  AdamW waits for
the training slice."""
