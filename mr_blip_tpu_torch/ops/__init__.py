"""Attention, normalization and rel-pos ops, each kernel beside its plain
PyTorch version."""
