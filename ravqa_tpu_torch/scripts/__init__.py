"""Experiment scripts of the port, one per script of the repo's scripts/
that it ports; each runs on the card with ``python -m``."""
