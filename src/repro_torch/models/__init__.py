"""The LM stack of the port (port of ``repro.models``): the dense family's
configuration, layers, attention and transformer, and the KV-cache PCA
compression.  MoE, Mamba and the other families are not ported yet."""
