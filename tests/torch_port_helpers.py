"""Shared set-up of the port's parity tests: the tiny JAX SyncFusion of
tests/test_diffusion_stack.py and its PyTorch port with the same
parameters, carried over by ``syncfusion_tpu_torch.convert``."""

import jax
import numpy as np
import torch

from syncfusion_tpu.models.encoder1d import Encoder1d
from syncfusion_tpu.models.syncfusion import SyncFusionDiffusion
from syncfusion_tpu.models.unet1d import UNet1d
from syncfusion_tpu_torch.convert import to_state_dict
from syncfusion_tpu_torch.core.config import EncoderConfig, UNetConfig
from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion as TorchSyncFusion
from test_diffusion_stack import ENC, L, UNET  # noqa: F401  (re-exported)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def tiny_pair(seed: int = 0, fold_cap: int = 0):
    """(JAX model, JAX params, port model on the CPU with those params)."""
    jm = SyncFusionDiffusion(unet=UNet1d(**UNET), onsets_encoder=Encoder1d(**ENC),
                             fold_cap=fold_cap)
    params = jm.init(jax.random.key(seed), L, batch=2)
    tm = TorchSyncFusion(UNetConfig(**UNET), EncoderConfig(**ENC))
    tm.load_state_dict(to_state_dict(to_numpy(params)), strict=True)
    return jm, params, tm.eval()


def t(a):
    """numpy -> torch (CPU)."""
    return torch.from_numpy(np.ascontiguousarray(a))


def n(x):
    """torch or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
