"""Full-float32 matmul policy for the port (utils/precision.py counterpart).

The JAX package traces its entry points under full-f32 dots because a
low-mantissa matmul (bf16 on the TPU's matrix unit) corrupted the stage-KKT
and contact algebra.  On an NVIDIA GPU the same hazard is TF32: it keeps
about ten mantissa bits, and cuDNN uses it for float32 by default.  The
port's entry points therefore turn it off everywhere.
"""
from __future__ import annotations

import torch


def set_full_f32_matmul() -> None:
    """Make every float32 matmul and convolution run in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

