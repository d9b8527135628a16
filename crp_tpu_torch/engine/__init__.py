"""Engines."""
