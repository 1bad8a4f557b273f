"""``python -m repro_torch.analysis`` entry point."""
import sys

from .cli import main

sys.exit(main())
