"""Benchmarks of the port, each a module run with ``python -m``."""
