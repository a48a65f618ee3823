"""The port's token pipeline (copy of ``repro.data``)."""
from .pipeline import DataConfig, TokenPipeline

__all__ = ["DataConfig", "TokenPipeline"]
