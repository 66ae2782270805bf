"""repro_torch — the PyTorch/CUDA port of the CURP reproduction.

``repro_torch.core`` is the protocol (a copy of the JAX package's pure-Python
modules, plus the device witness and the fused cluster batch over torch
tensors); ``repro_torch.kernels`` holds the hand-written CUDA kernels for
Hopper (``csrc/``), their plain PyTorch versions (``ref.py``) and the
wrappers that pick between them by the tensors' device (``ops.py``).  The
package imports torch and numpy, never jax, and nothing of ``repro``.
"""
