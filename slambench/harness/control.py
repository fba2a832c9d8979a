"""The correctness control: float32 matrix products in TF32.

The configurations state float32 with TF32 off (the port sets
``allow_tf32 = False``). The nearest precision below is TF32: a tensor
core rounds each float32 operand of a product to 10 mantissa bits and
adds the products in float32. ``tf32_products`` does exactly that
rounding, to the nearest and ties to even, on the float32 operands of
every matrix product the reference makes (``@``, ``matmul``, ``mm``,
``bmm``, ``einsum``, ``tensordot``, ``linear``), on the CPU as on the
card, so the control is one definition wherever it runs.
"""
from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

_PRODUCTS = {torch.matmul, torch.mm, torch.bmm, torch.einsum,
             torch.tensordot, torch.nn.functional.linear,
             torch.Tensor.matmul, torch.Tensor.__matmul__,
             torch.Tensor.__rmatmul__, torch.Tensor.mm, torch.Tensor.bmm}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` with its mantissa rounded to TF32's 10 bits."""
    bits = x.contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0xFFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32).reshape(x.shape)


def _round(a):
    if isinstance(a, torch.Tensor) and a.dtype == torch.float32:
        return round_tf32(a)
    if isinstance(a, (list, tuple)):
        return type(a)(_round(x) for x in a)
    return a


class tf32_products(TorchFunctionMode):
    """Within the block, every float32 matrix product of torch rounds its
    operands to TF32 first."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = _round(args)
            kwargs = {k: _round(v) for k, v in kwargs.items()}
        return func(*args, **kwargs)
