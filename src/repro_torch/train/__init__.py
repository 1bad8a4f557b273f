"""Training (port of ``repro.train``): AdamW and its schedules, int8
error-feedback gradient compression, and the train step over
``models.loss_fn``.  Parameters and optimizer state are the port's nested
dicts and lists of tensors (``repro_torch.tree``)."""
from .compress import compress_decompress, init_residual
from .optimizer import (AdamWConfig, adamw_update, global_norm,
                        init_opt_state, schedule_fn)
from .step import make_train_step

__all__ = ["AdamWConfig", "schedule_fn", "init_opt_state", "global_norm",
           "adamw_update", "init_residual", "compress_decompress",
           "make_train_step"]
