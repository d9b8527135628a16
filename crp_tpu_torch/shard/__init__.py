"""Padded stacked layout of sharded dense matrices."""
