"""LM serving of the port: prefill/decode steps and continuous batching
(port of the LM half of ``repro.serve``; the index services live in
``repro_torch.index``)."""
from .batcher import ContinuousBatcher, Request
from .step import make_decode_step, make_prefill_step

__all__ = ["ContinuousBatcher", "Request", "make_decode_step",
           "make_prefill_step"]
