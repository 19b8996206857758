"""COD evaluation metrics of the port (see metrics/torch_metrics.py)."""
