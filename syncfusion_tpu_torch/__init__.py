"""PyTorch/CUDA port of SyncFusion for an NVIDIA H100.

The JAX package ``syncfusion_tpu`` beside it is the reference: module names
here mirror it, public functions keep its (batch, length, channels) layout,
and the tests in ``tests/test_torch_*.py`` hold each module against its JAX
counterpart on the CPU.  The TPU kernels on the generation and training
paths, the flash-attention forward and its backward (dQ; dK and dV), are
hand-written CUDA kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``).
"""

from syncfusion_tpu_torch.device import default_device

__all__ = ["default_device"]
