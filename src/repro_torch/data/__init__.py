"""The learned-index-backed training data pipeline (port of
``repro.data``): host numpy, no torch."""
