"""The port's LM stack: blocks, configs, init/forward/decode/loss entry
points (port of ``repro.models``), for every block type."""
from .config import ModelConfig, MoEConfig, simple_decoder
from .convert import opt_state_from_jax, params_from_jax
from .model import (active_param_count, decode_step, forward, init_caches,
                    init_params, loss_fn, param_count, prefill)

__all__ = ["ModelConfig", "MoEConfig", "simple_decoder", "init_params",
           "forward", "init_caches", "prefill", "decode_step", "loss_fn",
           "param_count", "active_param_count", "params_from_jax",
           "opt_state_from_jax"]
