"""Checkpointing — port of ``repro.checkpoint`` on trees of torch
tensors."""
from . import checkpoint
from .checkpoint import AsyncCheckpointer, load, load_latest, save

__all__ = ["AsyncCheckpointer", "checkpoint", "load", "load_latest", "save"]
