"""spegnet_tpu_torch: the PyTorch / CUDA port of spegnet_tpu for NVIDIA Hopper.

The JAX package ``spegnet_tpu`` is the reference this package is held
against.  This package imports ``torch`` and never ``jax``.  Module names
mirror the JAX package; the TPU's Pallas kernels are replaced by
hand-written CUDA kernels for ``sm_90a`` (``csrc/``, built and loaded by
``kernels.py`` on first use).  Every kernel wrapper runs its plain PyTorch
version for a tensor on the CPU and launches its kernel (or raises) for a
CUDA tensor.

Entry points: ``python -m spegnet_tpu_torch predict --model <.pth> --input
<image|dir>`` and ``python -m spegnet_tpu_torch train [--config <yaml>]``
(same arguments and output trees as ``main.py``); both run on the card
unless ``--device cpu`` is given.
"""

__version__ = "0.1.0"
