"""The port's LM stack: blocks, configs, init/forward/decode entry points
(port of ``repro.models``), for every block type but the xLSTM pair."""
from .config import ModelConfig, MoEConfig, simple_decoder
from .convert import params_from_jax
from .model import (active_param_count, decode_step, forward, init_caches,
                    init_params, param_count, prefill)

__all__ = ["ModelConfig", "MoEConfig", "simple_decoder", "init_params",
           "forward", "init_caches", "prefill", "decode_step", "param_count",
           "active_param_count", "params_from_jax"]
