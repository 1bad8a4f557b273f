"""Checkpointing (port of ``repro.checkpoint``): npz parts + a JSON
manifest, async, atomic, crc-verified."""
from . import manager

__all__ = ["manager"]
