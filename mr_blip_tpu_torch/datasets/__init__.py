"""Annotation datasets, builders, the synthetic video scheme and the loaders."""
