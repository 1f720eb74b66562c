"""Evaluation: the inter-method (notebook 5) point-cloud metrics."""
