"""Plain PyTorch versions of the kernels.

Counterpart of ``repro.kernels.ref``.  The CPU path of ``ops`` runs these,
and the card's kernels are held against them: the INT8 kernels bit for
bit, flash attention within the reference's float tolerances.

PyTorch has no int32 ``conv2d`` or ``matmul`` on CUDA, so the integer
accumulators are computed in float64 and cast to int32.  That is exact:
a ResNet-18 accumulator is at most 127^2 * 9 * 256 = 37.2M in magnitude,
far below 2^53 (float32 would not be: 37.2M > 2^24).

The requantization epilogue ``(acc * sx) * sw[n] + bias[n]`` runs as
separate elementwise float32 ops, each rounded to nearest: the kernels
round each step the same way.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.cnn.layers import conv_pads

#: flash attention's tolerances on the card: max |d| against the plain
#: version on the f32 upcast (f32 inputs, and bf16 ones), and for bf16
#: inputs against the plain version in bf16
FLASH_F32_TOL = 2e-4
FLASH_BF16_TOL = 2e-2


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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Plain softmax attention; q (B, H, S, hd), k/v (B, KV, S, hd) with KV
    dividing H; f32 result.  As in the reference, the logits' einsum runs
    in the inputs' dtype before the f32 cast, and the rest in f32."""
    B, H, S, hd = q.shape
    if k.shape[1] != H:     # head h reads KV head h // (H // KV)
        k = torch.repeat_interleave(k, H // k.shape[1], dim=1)
        v = torch.repeat_interleave(v, H // v.shape[1], dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32)
    logits = logits / math.sqrt(hd)
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    idx = torch.arange(S, device=q.device)
    d = idx[:, None] - idx[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= d >= 0
    if window is not None:
        ok &= d < window
    logits = torch.where(ok[None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.to(torch.float32))


def check_flash(got: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, causal: bool, window: Optional[int],
                softcap: Optional[float], label: str):
    """Holds a flash kernel's output ``got`` against the plain version on
    the same inputs: max |d| against the f32 upcast within
    ``FLASH_F32_TOL`` and, for bf16 inputs, against the plain version in
    bf16 within ``FLASH_BF16_TOL``; raises AssertionError otherwise.
    Returns (f32 error, bf16 error or None)."""
    want = flash_attention_ref(*(t.float() for t in (q, k, v)), causal=causal,
                               window=window, softcap=softcap)
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"flash_attention {label}: bad output")
    err = (got - want).abs().max().item()
    if not err <= FLASH_F32_TOL:
        raise AssertionError(f"flash_attention {label}: max |d| {err:.3e} > "
                             f"{FLASH_F32_TOL} against the f32 plain version")
    if q.dtype != torch.bfloat16:
        return err, None
    want16 = flash_attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    err16 = (got - want16).abs().max().item()
    if not err16 <= FLASH_BF16_TOL:
        raise AssertionError(f"flash_attention {label}: max |d| {err16:.3e} "
                             f"> {FLASH_BF16_TOL} against the bf16 plain")
    return err, err16
