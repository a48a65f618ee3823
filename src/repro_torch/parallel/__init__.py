"""Sharding helpers of the port (port of ``repro.parallel``): so far the
shape arithmetic that single-device code shares with the mesh code."""
