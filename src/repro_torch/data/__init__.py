"""Data — port of ``repro.data``: ``pipeline`` is a copy of the
reference's numpy module (pinned to it by ``tests/test_torch_train.py``)."""
from .pipeline import DataConfig, SyntheticLM

__all__ = ["DataConfig", "SyntheticLM"]
