"""The control of the comparison: TF32, the precision next below the
configurations' float32 with TF32 off. Inside `TF32Inputs` every float32
matrix product (matmul, mm, bmm, einsum, linear and the fused add forms)
takes its inputs rounded to TF32's 10-bit mantissa, round to nearest,
and accumulates in float32, as the tensor cores do with TF32 on. It runs
the same on the CPU and the card."""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_map

_PRODUCTS = {
    torch.matmul, torch.mm, torch.bmm, torch.einsum, torch.addmm, torch.baddbmm, torch.nn.functional.linear,
    torch.Tensor.matmul, torch.Tensor.mm, torch.Tensor.bmm, torch.Tensor.__matmul__, torch.Tensor.__rmatmul__,
}


def round_tf32(x):
    """float32 tensors rounded to TF32 (10 mantissa bits); anything else as it is."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).reshape(x.shape)


class TF32Inputs(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args, kwargs = tree_map(round_tf32, args), tree_map(round_tf32, kwargs)
        return func(*args, **kwargs)
