"""Command-line entry points of the port, each runnable as ``python -m``."""
