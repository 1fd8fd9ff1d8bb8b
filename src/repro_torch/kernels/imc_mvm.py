"""INT8 weight-stationary matmul with fused requantization on Hopper.

Counterpart of ``repro.kernels.imc_mvm``: (M, K) int8 x (K, N) int8 ->
(M, N) f32, ``(acc * sx) * sw[n] + bias[n]`` with exact int32
accumulation.  The kernel is ``csrc/imc_mvm.cu`` (``mma.sync`` m16n8k32
on the s8 tensor cores, split K inside a block; its source note says what
bounds it and how it is laid out); its plain version is
``ref.imc_mvm_ref``.  Two instances, by how qx rows are staged: 16-byte
``cp.async`` where K % 16 == 0 and qx is 16-byte aligned, byte by byte
otherwise.  The rule is the C entry ``imc_mvm_instance``;
``mvm_instance`` mirrors it.

``imc_mvm`` takes CUDA tensors only.  ``ops.quantized_matmul`` sends CPU
tensors to the plain version.  ``imc_mvm.launches`` counts the kernel's
launches and ``imc_mvm.launches_by_instance`` counts them per instance.
``mvm_launcher`` is its checked launch without the count, for timing the
kernel alone.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

#: instance names in the C rule's order (``imc_mvm_instance``'s value)
INSTANCES = ("cp_async", "gather")


def mvm_instance(k: int, aligned: bool) -> str:
    """The instance that serves depth K and a 16-byte aligned (or not) qx:
    mirrors the C entry ``imc_mvm_instance``."""
    if k <= 0:
        raise ValueError(f"bad depth K={k}")
    return INSTANCES[0 if aligned and k % 16 == 0 else 1]


def device_scalar(s, device) -> torch.Tensor:
    """``s`` as a one-element float32 tensor on ``device`` (a number is
    filled in by a kernel, with no host-to-device copy)."""
    if isinstance(s, torch.Tensor):
        if s.numel() != 1:
            raise ValueError(f"expected a scalar scale, got shape {tuple(s.shape)}")
        return s.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(s), dtype=torch.float32, device=device)


def channel_vector(v: Optional[torch.Tensor], n: int, device) -> torch.Tensor:
    """Per-channel float32 vector of length ``n`` (zeros if None)."""
    if v is None:
        return torch.zeros((n,), dtype=torch.float32, device=device)
    if v.shape != (n,):
        raise ValueError(f"expected shape ({n},), got {tuple(v.shape)}")
    return v.to(device=device, dtype=torch.float32).contiguous()


def check_int8(t: torch.Tensor, name: str, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.int8 or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d int8 tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")


def mvm_launcher(qx: torch.Tensor, qw: torch.Tensor, sx, sw: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
    """One quantized matmul, checked: (``launch``, out, instance), as
    ``conv2d.conv_launcher``.  ``imc_mvm`` launches it once and counts."""
    check_int8(qx, "qx", 2)
    check_int8(qw, "qw", 2)
    M, K = qx.shape
    K2, N = qw.shape
    if K != K2 or qw.device != qx.device:
        raise ValueError(f"shape/device mismatch: qx {tuple(qx.shape)} on "
                         f"{qx.device}, qw {tuple(qw.shape)} on {qw.device}")
    dev = qx.device
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return None, out, None
    instance = mvm_instance(K, qx.data_ptr() % 16 == 0)
    sx_t = device_scalar(sx, dev)
    sw_t = channel_vector(sw, N, dev)
    b_t = channel_vector(bias, N, dev)
    fn = _build.load("imc_mvm", "imc_mvm_launch", _ARGTYPES)
    args = (qx.data_ptr(), qw.data_ptr(), sx_t.data_ptr(), sw_t.data_ptr(),
            b_t.data_ptr(), out.data_ptr(), M, K, N)

    def launch(stream, keep=(qx, qw, sx_t, sw_t, b_t, out)):
        # ``keep``: the buffers behind ``args`` live as long as ``launch``
        _build.check(fn(*args, stream), "imc_mvm")
    return launch, out, instance


def imc_mvm(qx: torch.Tensor, qw: torch.Tensor, sx, sw: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantized matmul on the card: (M, K) int8 x (K, N) int8 -> (M, N)
    f32.  ``sx`` scalar, ``sw`` (N,), ``bias`` (N,) or None."""
    launch, out, instance = mvm_launcher(qx, qw, sx, sw, bias)
    if launch is None:
        return out
    with torch.cuda.device(out.device):
        launch(torch.cuda.current_stream(out.device).cuda_stream)
    imc_mvm.launches += 1
    imc_mvm.launches_by_instance[instance] += 1
    return out


imc_mvm.launches = 0
imc_mvm.launches_by_instance = dict.fromkeys(INSTANCES, 0)
