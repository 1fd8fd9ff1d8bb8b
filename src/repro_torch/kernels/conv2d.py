"""INT8 convolution with fused requantization on Hopper.

Counterpart of ``repro.kernels.conv2d``: x (B, H, W, Cin) int8 NHWC,
w (KH, KW, Cin, Cout) int8 HWIO -> (B, Ho, Wo, Cout) f32, exact int32
accumulation, ``(acc * sx) * sw[co] + bias[co]``.  The kernel is
``csrc/imc_conv2d.cu`` (an implicit GEMM that gathers taps on the fly; its
source note says what bounds it and how it is laid out); its plain version
is ``ref.conv2d_ref``.  Padding is explicit, so SAME (split floor/ceil as
XLA) and VALID both go through the kernel, at any spatial size.

``imc_conv2d`` takes CUDA tensors only.  ``ops.quantized_conv2d`` sends CPU
tensors to the plain version.  ``imc_conv2d.launches`` counts the kernel's
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .imc_mvm import channel_vector, check_int8, device_scalar

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 14
             + [ctypes.c_void_p])


def pack_weight(qw: torch.Tensor) -> torch.Tensor:
    """HWIO int8 -> (Cout, Kw) int32 words: row ``co`` holds
    ``qw[..., co]`` flattened in (kh, kw, ci) order and zero-padded to a
    multiple of 4 values."""
    KH, KW, Cin, Cout = qw.shape
    K = KH * KW * Cin
    Kp = -(-K // 4) * 4
    packed = torch.zeros((Cout, Kp), dtype=torch.int8, device=qw.device)
    packed[:, :K] = qw.reshape(K, Cout).t()
    return packed.view(torch.int32)


def imc_conv2d(qx: torch.Tensor, qw: torch.Tensor, sx, sw: torch.Tensor,
               bias: Optional[torch.Tensor] = None, *, stride: int = 1,
               pads: Tuple[int, int, int, int] = (0, 0, 0, 0)) -> torch.Tensor:
    """INT8 conv on the card with zero padding ``pads`` = (top, bottom,
    left, right).  ``sx`` scalar, ``sw`` (Cout,), ``bias`` (Cout,) or
    None."""
    check_int8(qx, "qx", 4)
    check_int8(qw, "qw", 4)
    B, H, W, Cin = qx.shape
    KH, KW, Cin2, Cout = qw.shape
    if Cin != Cin2 or qw.device != qx.device:
        raise ValueError(f"shape/device mismatch: qx {tuple(qx.shape)} on "
                         f"{qx.device}, qw {tuple(qw.shape)} on {qw.device}")
    top, bottom, left, right = pads
    if stride < 1 or min(pads) < 0:
        raise ValueError(f"bad stride {stride} or pads {pads}")
    Ho = (H + top + bottom - KH) // stride + 1
    Wo = (W + left + right - KW) // stride + 1
    dev = qx.device
    out = torch.empty((B, max(Ho, 0), max(Wo, 0), Cout), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    wp = pack_weight(qw)
    K = KH * KW * Cin
    vec = int(Cin % 4 == 0 and qx.data_ptr() % 4 == 0)
    sx_t = device_scalar(sx, dev)
    sw_t = channel_vector(sw, Cout, dev)
    b_t = channel_vector(bias, Cout, dev)
    fn = _build.load("imc_conv2d", "imc_conv2d_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(qx.data_ptr(), wp.data_ptr(), sx_t.data_ptr(), sw_t.data_ptr(),
                b_t.data_ptr(), out.data_ptr(), B, H, W, Cin, Ho, Wo, Cout, KW,
                stride, top, left, K, wp.shape[1], vec, stream)
    _build.check(rc, "imc_conv2d")
    imc_conv2d.launches += 1
    return out


imc_conv2d.launches = 0
