"""Deterministic synthetic data (the port's own copy of
``repro.data.pipeline``, which needs only numpy)."""
from .pipeline import DataConfig, SyntheticImages, SyntheticLM, make_pipeline

__all__ = ["DataConfig", "SyntheticImages", "SyntheticLM", "make_pipeline"]
