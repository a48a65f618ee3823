"""The LM stack of the port (port of ``repro.models``): the configuration,
layers, attention, Mamba, MoE and the transformer of every family, for
serving and training, and the KV-cache PCA compression."""
