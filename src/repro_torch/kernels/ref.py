"""Plain PyTorch versions of the INT8 kernels.

Counterpart of ``repro.kernels.ref``.  The CPU path of ``ops`` runs these,
and the card's kernels are held against them bit for bit.

PyTorch has no int32 ``conv2d`` or ``matmul`` on CUDA, so the integer
accumulators are computed in float64 and cast to int32.  That is exact:
a ResNet-18 accumulator is at most 127^2 * 9 * 256 = 37.2M in magnitude,
far below 2^53 (float32 would not be: 37.2M > 2^24).

The requantization epilogue ``(acc * sx) * sw[n] + bias[n]`` runs as
separate elementwise float32 ops, each rounded to nearest: the kernels
round each step the same way.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.cnn.layers import conv_pads


def _f32(t, device) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32, device=device)


def matmul_acc(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """INT8 (..., K) x INT8 (K, N) -> exact INT32 (..., N)."""
    return (qx.double() @ qw.double()).to(torch.int32)


def conv2d_acc(qx: torch.Tensor, qw: torch.Tensor, stride: int,
               pads: Tuple[int, int, int, int]) -> torch.Tensor:
    """INT8 NHWC x INT8 HWIO -> exact INT32 NHWC, zero padding
    ``(top, bottom, left, right)``."""
    top, bottom, left, right = pads
    x = F.pad(qx.permute(0, 3, 1, 2).double(), (left, right, top, bottom))
    acc = F.conv2d(x, qw.permute(3, 2, 0, 1).double(), stride=stride)
    return acc.permute(0, 2, 3, 1).contiguous().to(torch.int32)


def requant(acc: torch.Tensor, sx, sw: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(acc * sx) * sw + bias`` in float32, per output channel (last
    axis)."""
    y = acc.float() * _f32(sx, acc.device) * _f32(sw, acc.device)
    if bias is not None:
        y = y + bias
    return y


def imc_mvm_ref(qx: torch.Tensor, qw: torch.Tensor, sx, sw: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """INT8 x INT8 -> INT32 -> requantized f32 (matches models.quant)."""
    return requant(matmul_acc(qx, qw), sx, sw, bias)


def conv2d_ref(qx: torch.Tensor, qw: torch.Tensor, sx, sw: torch.Tensor,
               bias: Optional[torch.Tensor] = None, stride: int = 1,
               pads: Optional[Tuple[int, int, int, int]] = None) -> torch.Tensor:
    """INT8 NHWC/HWIO conv, integer accumulate, requant.  ``pads`` is
    ``(top, bottom, left, right)``; None means SAME."""
    if pads is None:
        pads = conv_pads(qx.shape[1], qx.shape[2], qw.shape[0], stride, "SAME")
    return requant(conv2d_acc(qx, qw, stride, pads), sx, sw, bias)
