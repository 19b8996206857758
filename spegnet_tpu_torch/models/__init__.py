"""SPEGNet model modules (PyTorch)."""
