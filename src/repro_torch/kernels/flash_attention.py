"""Flash attention (online softmax, O(S) memory) on Hopper.

Counterpart of ``repro.kernels.flash_attention``: q (B, H, S, hd) and
k/v (B, KV, S, hd) in float32 or bfloat16 -> (B, H, S, hd) float32, with
scale ``1/sqrt(hd)``, the tanh softcap applied before masking, and the
masks causal ``q - k >= 0``, window ``q - k < window`` and padded keys
``k < S``.  Masked logits are ``-1e30``; the denominator is clamped at
``1e-30``.  The TPU kernel takes K/V with H heads; here KV may also divide
H (head h reads KV head ``h // (H // KV)``), so MQA/GQA callers pass
their K/V without expanding them.

The kernel is ``csrc/flash_attention.cu`` (its source note says what
bounds it and how it is laid out); its plain version is
``ref.flash_attention_ref``.  ``flash_attention`` takes CUDA tensors
only; ``ops.attention`` sends CPU tensors to the plain version.  Inputs
may be strided views (a (B, S, H, hd) projection transposed to
(B, H, S, hd)) as long as the head dimension is contiguous.

The source holds two instances of the function.  bfloat16 inputs with
``hd <= TC_MAX_HEAD_DIM`` go to the tensor-core instance (``TC_*`` and
``tc_*`` below describe it); float32 inputs and wider bfloat16 go to the
CUDA-core instance (``BQ``, ``BK``, ``smem_stride``, ``smem_bytes``).
The rule is the C entry ``flash_attention_instance``;
``uses_tensor_cores`` mirrors it (``chip_smoke.py`` holds the two
together on the card).  ``flash_attention.launches`` counts every launch
and ``flash_attention.instance_launches`` counts them per instance.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p])

#: CUDA-core instance's tile sizes (query rows, key rows)
BQ, BK = 64, 32
#: largest head dimension the CUDA-core instance is instantiated for
MAX_HEAD_DIM = 512
#: dynamic shared memory a block may use on the H100 (227 KB)
MAX_SMEM_BYTES = 232_448
#: the window that means "no window" (``configs.GLOBAL_WINDOW``)
NO_WINDOW = 1 << 30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: tensor-core instance: query rows per block (4 warps x 16), key rows per
#: tile, and the widest head dimension of its register plan
TC_BQ, TC_BK = 64, 32
TC_MAX_HEAD_DIM = 288
#: instance names, as counted in ``flash_attention.instance_launches``
TENSOR_CORE, CUDA_CORE = "tensor_core", "cuda_core"


def smem_stride(hd: int, elem_bytes: int) -> int:
    """Padded shared-memory row stride (elements): an odd number of 32-bit
    words, so that 16 rows read at one column fall on 16 banks.  Must
    agree with ``smem_stride`` in the CUDA source."""
    if elem_bytes == 4:
        return hd + 1 if hd % 2 == 0 else hd
    s = (hd + 1) // 2 * 2
    return s + 2 if (s // 2) % 2 == 0 else s


def smem_bytes(hd: int, elem_bytes: int) -> int:
    """Dynamic shared memory of one block: Q, K and V tiles in the inputs'
    dtype and the f32 probability tile."""
    return (BQ + 2 * BK) * smem_stride(hd, elem_bytes) * elem_bytes \
        + BQ * (BK + 1) * 4


def uses_tensor_cores(dtype: torch.dtype, hd: int) -> bool:
    """Whether (dtype, hd) goes to the tensor-core instance: bfloat16 with
    hd within its register plan.  Mirrors ``flash_attention_instance`` in
    the CUDA source."""
    return dtype == torch.bfloat16 and 0 < hd <= TC_MAX_HEAD_DIM


def tc_steps(hd: int) -> int:
    """16-column steps of the tensor-core instance serving ``hd`` (its
    padded head width is 16 times this).  Must agree with ``tc_steps`` in
    the CUDA source."""
    ks = (hd + 15) // 16
    for steps in (2, 4, 8, 16):
        if ks <= steps:
            return steps
    return 18


def tc_smem_stride(hd: int) -> int:
    """Tensor-core instance's shared-memory row stride (bf16 elements):
    the padded width in 16-byte chunks plus one, an odd count, so rows are
    16-byte aligned for ``ldmatrix`` and the 8 rows of one of its phases
    fall in 8 distinct 16-byte bank groups."""
    return (2 * tc_steps(hd) + 1) * 8


def tc_smem_bytes(hd: int) -> int:
    """Tensor-core instance's dynamic shared memory: one Q, one K and one V
    tile in bf16."""
    return (TC_BQ + 2 * TC_BK) * tc_smem_stride(hd) * 2


def _check(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in _DTYPES or t.ndim != 4:
        raise ValueError(f"{name} must be a 4-d float32 or bfloat16 tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if t.stride(3) != 1 and t.shape[3] > 1:
        raise ValueError(f"{name}: the head dimension must be contiguous, "
                         f"strides {t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """(B, H, S, hd) attention on the card, f32 result; k/v (B, KV, S, hd)
    with KV dividing H.  ``window`` None means no window."""
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check(t, name)
    B, H, S, hd = q.shape
    KV = k.shape[1]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (S, hd)
            or KV == 0 or H % KV != 0):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device \
            or v.device != q.device:
        raise ValueError("q, k and v must share dtype and device")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    tensor_cores = uses_tensor_cores(q.dtype, hd)
    if tensor_cores:
        if -(-S // TC_BQ) > 65_535:
            raise ValueError(f"S = {S} exceeds the grid's y extent")
    else:
        elem = q.element_size()
        if hd > MAX_HEAD_DIM or smem_bytes(hd, elem) > MAX_SMEM_BYTES:
            raise ValueError(f"head_dim {hd} in {q.dtype} exceeds the "
                             f"kernel's shared memory")
        if B * H > 65_535:
            raise ValueError(f"B*H = {B * H} exceeds the grid's y extent")
    dev = q.device
    out = torch.empty((B, H, S, hd), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    win = NO_WINDOW if window is None else min(int(window), NO_WINDOW)
    fn = _build.load("flash_attention", "flash_attention_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], B, H, KV, S, hd,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                1.0 / math.sqrt(hd), int(causal), win,
                0.0 if softcap is None else float(softcap), stream)
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    flash_attention.instance_launches[
        TENSOR_CORE if tensor_cores else CUDA_CORE] += 1
    return out


flash_attention.launches = 0
flash_attention.instance_launches = {TENSOR_CORE: 0, CUDA_CORE: 0}
