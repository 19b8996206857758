"""Inference engines (PyTorch)."""
