"""Shared utilities: profiling."""
