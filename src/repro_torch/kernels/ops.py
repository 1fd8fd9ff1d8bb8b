"""Public wrappers around the INT8 kernels, dispatched by device.

Counterpart of ``repro.kernels.ops``.  A CUDA tensor launches the Hopper
kernel (or raises); a CPU tensor takes the kernel's plain version in
``ref``, which stands in for the reference's interpret mode.  There is no
fallback from one to the other and no spatial-size limit: the TPU kernel's
VMEM bound (``_CONV_KERNEL_MAX_HW``) does not apply to the CUDA kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.cnn.layers import conv_pads
from . import ref
from .conv2d import imc_conv2d
from .imc_mvm import imc_mvm


def quantized_matmul(qx: torch.Tensor, qw: torch.Tensor, sx, sw: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """INT8 (M,K)x(K,N) -> f32, fused requant (IMC crossbar analogue)."""
    if qx.device.type == "cpu":
        return ref.imc_mvm_ref(qx, qw, sx, sw, bias)
    return imc_mvm(qx, qw, sx, sw, bias)


def quantized_conv2d(qx: torch.Tensor, qw: torch.Tensor, sx, sw: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, *, stride: int = 1,
                     padding: str = "SAME") -> torch.Tensor:
    """INT8 NHWC conv with SAME or VALID padding, fused requant."""
    pads = conv_pads(qx.shape[1], qx.shape[2], qw.shape[0], stride, padding)
    if qx.device.type == "cpu":
        return ref.conv2d_ref(qx, qw, sx, sw, bias, stride=stride, pads=pads)
    return imc_conv2d(qx, qw, sx, sw, bias, stride=stride, pads=pads)
