"""Entry points and the dry-run plane (port of ``repro.launch``): ``python
-m repro_torch.launch.train``, the trainer; ``python -m
repro_torch.launch.dryrun``, the multi-pod dry run on meta tensors; the
mesh, the sharding rules, the cells' specs, the flop count and the
collective accounting.  Every name resolves on first access (PEP 562), so
the host-only modules (``sharding``, ``hlo_analysis``) import without
torch."""
import importlib

_EXPORTS = {
    "init_ranks": ".mesh", "make_host_mesh": ".mesh",
    "make_production_mesh": ".mesh", "place": ".mesh",
    "distribute_tree": ".mesh",
    "input_specs": ".specs", "make_step_and_specs": ".specs",
    "param_shapes": ".specs", "cache_shapes": ".specs",
    "count_flops": ".flops_count", "flops_global": ".flops_count",
    "analyze_collectives": ".hlo_analysis",
    "trace_collectives": ".hlo_analysis",
    "run_cell": ".dryrun",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name], __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
