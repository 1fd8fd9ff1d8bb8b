"""INT8 convolution with fused requantization on Hopper.

Counterpart of ``repro.kernels.conv2d``: x (B, H, W, Cin) int8 NHWC,
w (KH, KW, Cin, Cout) int8 HWIO -> (B, Ho, Wo, Cout) f32, exact int32
accumulation, ``(acc * sx) * sw[co] + bias[co]``.  The kernel is
``csrc/imc_conv2d.cu`` (an implicit GEMM on the s8 tensor cores,
``mma.sync`` m16n8k32, that gathers taps on the fly; its source note says
what bounds it and how it is laid out); its plain version is
``ref.conv2d_ref``.  Padding is explicit, so SAME (split floor/ceil as
XLA) and VALID both go through the kernel, at any spatial size.

The kernel has six instances: the N tile (32, 64 or 128, by Cout) times
the staging of the im2col rows (16-byte ``cp.async`` where Cin % 16 == 0
and x is 16-byte aligned, byte gather otherwise).  The rule is the C
entry ``imc_conv2d_instance``; ``conv_instance`` mirrors it
(``chip_smoke.py`` holds the two together on the card).

``imc_conv2d`` takes CUDA tensors only.  ``ops.quantized_conv2d`` sends CPU
tensors to the plain version.  ``imc_conv2d.launches`` counts the kernel's
launches and ``imc_conv2d.launches_by_instance`` counts them per instance.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .imc_mvm import channel_vector, check_int8, device_scalar

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 14
             + [ctypes.c_void_p])

#: K depth of one ``mma.sync`` m16n8k32 step; packed weight rows and the
#: im2col rows are zero-padded to a multiple of it
K_STEP = 32

#: instance names in the C rule's order (``imc_conv2d_instance``'s value)
INSTANCES = tuple(f"{staging}_n{bn}" for staging in ("cp_async", "gather")
                  for bn in (32, 64, 128))


def conv_instance(cin: int, cout: int, aligned: bool) -> str:
    """The instance that serves (Cin, Cout, 16-byte aligned x): mirrors
    the C entry ``imc_conv2d_instance``."""
    if cin <= 0 or cout <= 0:
        raise ValueError(f"bad channels Cin={cin}, Cout={cout}")
    tile = 0 if cout <= 32 else 1 if cout <= 64 else 2
    return INSTANCES[(0 if aligned and cin % 16 == 0 else 3) + tile]


def pack_weight(qw: torch.Tensor) -> torch.Tensor:
    """HWIO int8 -> (Cout, Kpad / 4) int32 words: row ``co`` holds
    ``qw[..., co]`` flattened in (kh, kw, ci) order and zero-padded to
    Kpad, a multiple of ``K_STEP`` (32) values.  Viewed as int8, the rows
    are the K-contiguous "col" B operand of the kernel's ``mma``."""
    KH, KW, Cin, Cout = qw.shape
    K = KH * KW * Cin
    Kp = -(-K // K_STEP) * K_STEP
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
    aligned = qx.data_ptr() % 16 == 0
    sx_t = device_scalar(sx, dev)
    sw_t = channel_vector(sw, Cout, dev)
    b_t = channel_vector(bias, Cout, dev)
    fn = _build.load("imc_conv2d", "imc_conv2d_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(qx.data_ptr(), wp.data_ptr(), sx_t.data_ptr(), sw_t.data_ptr(),
                b_t.data_ptr(), out.data_ptr(), B, H, W, Cin, Ho, Wo, Cout, KW,
                stride, top, left, K, wp.shape[1], int(aligned), stream)
    _build.check(rc, "imc_conv2d")
    imc_conv2d.launches += 1
    imc_conv2d.launches_by_instance[conv_instance(Cin, Cout, aligned)] += 1
    return out


imc_conv2d.launches = 0
imc_conv2d.launches_by_instance = dict.fromkeys(INSTANCES, 0)
