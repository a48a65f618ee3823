"""The port's optimizer side (port of ``repro.optim``): AdamW and the PCA
consumers, spectral gradient telemetry and PCA gradient compression."""
