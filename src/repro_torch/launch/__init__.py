"""Entry points (port of ``repro.launch``): ``python -m
repro_torch.launch.train``, the single-card trainer."""
