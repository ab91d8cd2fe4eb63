"""PyTorch/CUDA port of SyncFusion for an NVIDIA H100.

The JAX package ``syncfusion_tpu`` beside it is the reference: module names
here mirror it, public functions keep its (batch, length, channels) layout,
and the tests in ``tests/test_torch_*.py`` hold each module against its JAX
counterpart on the CPU.  The one TPU kernel on the generation path, flash
attention, is a hand-written CUDA kernel (``csrc/flash_fwd.cu``).
"""

from syncfusion_tpu_torch.device import default_device

__all__ = ["default_device"]
