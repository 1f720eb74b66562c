"""Shared utilities: profiling, streams, visualization."""
