"""int16 wire format of the training batches (the numpy side of
``syncfusion_tpu/ops/quantize.py``'s ``float32_to_int16``): the reference's
clamp and scale.  The trainer takes it back to f32 on the device
(``wav / 32767``)."""

from __future__ import annotations

import numpy as np


def float32_to_int16(x: np.ndarray) -> np.ndarray:
    return (np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16)

