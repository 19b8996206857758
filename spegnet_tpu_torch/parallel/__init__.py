"""Data parallelism over torch.distributed (port of spegnet_tpu/parallel)."""
