"""Public wrappers around the kernels, dispatched by device.

Counterpart of ``repro.kernels.ops``.  A CUDA tensor launches the Hopper
kernel (or raises); a CPU tensor takes the kernel's plain version in
``ref``, which stands in for the reference's interpret mode.  There is no
fallback from one to the other and no spatial-size limit: the TPU kernel's
VMEM bound (``_CONV_KERNEL_MAX_HW``) does not apply to the CUDA kernel.

The CUDA kernels write their outputs through a ctypes launch, which no
autograd graph records: the kernel route refuses an input that asks for a
gradient (:func:`refuse_grad`).  The plain versions stay differentiable.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.cnn.layers import conv_pads
from . import ref
from .conv2d import imc_conv2d
from .flash_attention import flash_attention
from .imc_mvm import imc_mvm


def refuse_grad(op: str, *tensors) -> None:
    """Raise if grad mode is on and any tensor of ``tensors`` requires
    grad: the kernel's output would carry no ``grad_fn`` and a loss through
    it would silently drop the gradients."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{op}: the CUDA kernel has no backward; call it "
                           f"under torch.no_grad() or on inputs that do not "
                           f"require grad")


def quantized_matmul(qx: torch.Tensor, qw: torch.Tensor, sx, sw: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """INT8 (M,K)x(K,N) -> f32, fused requant (IMC crossbar analogue)."""
    if qx.device.type == "cpu":
        return ref.imc_mvm_ref(qx, qw, sx, sw, bias)
    refuse_grad("quantized_matmul", qx, qw, sx, sw, bias)
    return imc_mvm(qx, qw, sx, sw, bias)


def quantized_conv2d(qx: torch.Tensor, qw: torch.Tensor, sx, sw: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, *, stride: int = 1,
                     padding: str = "SAME",
                     packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """INT8 NHWC conv with SAME or VALID padding, fused requant.
    ``packed``: ``qw`` in the kernel's layout (``conv2d.pack_weight``),
    packed once by a deployment; the plain version reads ``qw``."""
    pads = conv_pads(qx.shape[1], qx.shape[2], qw.shape[0], stride, padding)
    if qx.device.type == "cpu":
        return ref.conv2d_ref(qx, qw, sx, sw, bias, stride=stride, pads=pads)
    refuse_grad("quantized_conv2d", qx, qw, sx, sw, bias)
    return imc_conv2d(qx, qw, sx, sw, bias, stride=stride, pads=pads,
                      packed=packed)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None) -> torch.Tensor:
    """Flash attention (B,H,S,hd) -> (B,H,S,hd) f32.  k/v may carry fewer
    heads (B,KV,S,hd), KV dividing H: head h attends with KV head
    ``h // (H // KV)``.  ``window`` None and ``GLOBAL_WINDOW`` agree."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    refuse_grad("attention", q, k, v)
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap)
