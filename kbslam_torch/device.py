"""Device selection and float32 matmul precision.

The port runs on the card: without a device name, ``pick_device``
returns the current CUDA device and raises when there is none. The CPU
is used only when the caller names it (the tests do).

The JAX tracking step runs under ``jax.default_matmul_precision
("highest")`` (kbslam/pipeline.py:153-158): the DLT normal matrices,
Kabsch and the Gauss-Newton solves need true float32 products. The
torch counterpart is to keep TF32 off for matmuls and for cuDNN.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def pick_device(name: Optional[Union[str, torch.device]] = None
                ) -> torch.device:
    """The device the port runs on: ``name`` when given, else the
    current CUDA device; raises when a CUDA device is asked for and there
    is none. Also sets full float32 precision (see module docstring)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kbslam_torch runs on a CUDA device and found none; pass "
            "device='cpu' (--device cpu) to run on the CPU")
    if name is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
