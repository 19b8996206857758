"""Plain PyTorch operators and the wrappers of the hand-written kernels."""
