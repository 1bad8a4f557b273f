"""Carry the reference's parameters over to the port.

``params_from_jax(tree, cfg, device)`` takes the pytree of
``repro.models.init_params`` with every leaf already a numpy array (the
caller maps ``np.asarray`` over it, so this module imports no JAX) and
returns the port's parameters.  The reference stacks a unit's layers on a
leading repeat axis (``repro/models/model.py`` ``_init_stacks``); the port
keeps one dict per layer, so ``tree["stacks"]["s0"]["b1"]["rec"]["wx"][r]``
becomes ``params["stacks"]["s0"][r]["b1"]["rec"]["wx"]``, and the encoder's
``enc_stacks`` the same way.  Every other path is the same in both.  Each
leaf must have the shape and type that ``init_params`` gives the port for
``cfg`` in the embedding's type, or this raises: so an MoE router stays f32
under bf16 weights, as both packages draw it.

``opt_state_from_jax(tree, cfg, device)`` does the same for the reference's
optimizer state (``repro.train.optimizer.init_opt_state``, with
``residual`` where compression is on): ``m``, ``v`` and ``residual`` are
f32 trees shaped like the parameters, and ``step`` an int32 scalar.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.index.engine import resolve_device

from .config import ModelConfig
from .model import Params, init_params


def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor (a copy); bfloat16 (ml_dtypes) goes
    through its bits, which numpy and torch lay out alike."""
    arr = np.array(arr, order="C")
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _convert(node, like, path: str, device: torch.device):
    if isinstance(like, torch.Tensor):
        if not isinstance(node, np.ndarray):
            raise ValueError(f"{path}: expected a numpy array, got "
                             f"{type(node).__name__}")
        t = _tensor(node, device)
        if t.shape != like.shape or t.dtype != like.dtype:
            raise ValueError(f"{path}: {tuple(t.shape)} {t.dtype} does not "
                             f"match the port's {tuple(like.shape)} "
                             f"{like.dtype}")
        return t
    if not isinstance(node, dict) or set(node) != set(like):
        got = sorted(node) if isinstance(node, dict) else type(node).__name__
        raise ValueError(f"{path}: keys {got} do not match the port's "
                         f"{sorted(like)}")
    return {k: _convert(node[k], like[k], f"{path}/{k}", device)
            for k in like}


def _layer(tree, r: int):
    """Layer ``r`` of a stacked subtree (every leaf indexed on axis 0)."""
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]


def params_from_jax(tree: dict, cfg: ModelConfig, device=None) -> Params:
    """The port's parameters from the reference's (numpy leaves)."""
    dev = resolve_device(device)
    like = init_params(cfg, dtype=_dtype_of(tree), device="meta")
    stacked = [k for k in ("stacks", "enc_stacks") if k in like]
    for key in stacked:
        got = tree.get(key, {})
        if set(got) != set(like[key]):
            raise ValueError(f"{key} {sorted(got)} do not match the port's "
                             f"{sorted(like[key])}")
    out = _convert({k: v for k, v in tree.items() if k not in stacked},
                   {k: v for k, v in like.items() if k not in stacked}, "",
                   dev)
    for key in stacked:
        out[key] = {}
        for si, layers in like[key].items():
            out[key][si] = [
                _convert(_layer(tree[key][si], r), layers[r],
                         f"/{key}/{si}[{r}]", dev)
                for r in range(len(layers))]
    return out


def _dtype_of(tree: dict) -> torch.dtype:
    """The parameters' type: that of the embedding."""
    return _tensor(np.asarray(tree["embed"])[:1], torch.device("cpu")).dtype


def opt_state_from_jax(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The port's optimizer state from the reference's (numpy leaves):
    ``m``, ``v`` (and ``residual``) in the port's per-layer layout, f32;
    ``step`` an int32 scalar tensor."""
    dev = resolve_device(device)
    trees = [k for k in ("m", "v", "residual") if k in tree]
    if set(tree) != {*trees, "step"} or not {"m", "v"} <= set(trees):
        raise ValueError(f"optimizer state keys {sorted(tree)}: expected "
                         f"m, v, step and optionally residual")
    out = {k: params_from_jax(tree[k], cfg, dev) for k in trees}
    for k in trees:
        if _dtype_of(tree[k]) != torch.float32:
            raise ValueError(f"optimizer state {k} must be float32")
    out["step"] = torch.tensor(int(np.asarray(tree["step"])),
                               dtype=torch.int32, device=dev)
    return out
