"""INT8 post-training quantization (the paper deploys INT8 models).

Counterpart of ``repro.models.quant``, with the same scheme:

* **Weights** — symmetric per-output-channel INT8:
  ``q_w[..., c] = round(w[..., c] / s_w[c])``, ``s_w[c] = max|w[...,c]| / 127``.
* **Activations** — symmetric per-tensor INT8, ``s_x = max|x| / 127`` over
  the whole tensor (the whole batch: a frame's result depends on its
  batch, as in the reference).
* **Compute** — INT8 x INT8 -> INT32 accumulate (exact), then
  ``y = acc * s_x * s_w + b``.
* **Optional AIMC noise hook** — additive Gaussian on the accumulator,
  drawn from a ``torch.Generator``.

``torch.round`` rounds half to even, as ``jnp.round`` does.  The
functions here are the plain path; ``repro_torch.kernels.ops`` runs the
same integer semantics through the card's kernels.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..kernels import ref
from .cnn import layers as L


class QTensor(NamedTuple):
    q: torch.Tensor          # int8 values
    scale: torch.Tensor      # per-channel (weights) or scalar (activations)


def _div127(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-8) / 127`` as a true quotient.  The divisor is a
    tensor on purpose: PyTorch's CUDA division by a Python number
    multiplies by its float32 reciprocal, which differs from the quotient
    in the last bit for some inputs and would move rounding boundaries."""
    return torch.clamp_min(amax, 1e-8) / torch.full_like(amax, 127.0)


def weight_scale(w: torch.Tensor, channel_axis: int = -1) -> torch.Tensor:
    axes = tuple(i for i in range(w.ndim) if i != channel_axis % w.ndim)
    return _div127(w.abs().amax(dim=axes))


def quantize_weight(w: torch.Tensor, channel_axis: int = -1) -> QTensor:
    s = weight_scale(w, channel_axis)
    shape = [1] * w.ndim
    shape[channel_axis % w.ndim] = -1
    q = torch.round(w / s.reshape(shape)).clamp(-127, 127).to(torch.int8)
    return QTensor(q, s)


def act_scale(x: torch.Tensor) -> torch.Tensor:
    return _div127(x.abs().amax())


def quantize_act(x: torch.Tensor,
                 scale: Optional[torch.Tensor] = None) -> QTensor:
    s = act_scale(x) if scale is None else scale
    q = torch.round(x / s).clamp(-127, 127).to(torch.int8)
    return QTensor(q, s)


def dequantize(t: QTensor, channel_axis: int = -1) -> torch.Tensor:
    s = t.scale
    if s.ndim > 0 and s.numel() > 1:
        shape = [1] * t.q.ndim
        shape[channel_axis % t.q.ndim] = -1
        s = s.reshape(shape)
    return t.q.float() * s


# ---------------------------------------------------------------------------
# integer compute paths
# ---------------------------------------------------------------------------

def int8_matmul_acc(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """INT8 x INT8 -> INT32 exact accumulation."""
    return ref.matmul_acc(qx, qw)


def _dequant_acc(acc: torch.Tensor, sx, sw, b, noise_std: float,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    acc = acc.float()
    if noise_std > 0.0 and generator is not None:
        acc = acc + noise_std * torch.randn(
            acc.shape, generator=generator, device=generator.device
        ).to(acc.device)
    return ref.requant(acc, sx, sw, b)


def quantized_matmul(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None,
                     x_scale: Optional[torch.Tensor] = None,
                     noise_std: float = 0.0,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Quantize -> integer matmul -> dequantize (+ optional AIMC noise)."""
    qx = quantize_act(x, x_scale)
    qw = quantize_weight(w, channel_axis=-1)
    acc = int8_matmul_acc(qx.q, qw.q)
    return _dequant_acc(acc, qx.scale, qw.scale, b, noise_std, generator)


def quantized_conv2d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None,
                     stride: int = 1, padding: str = "SAME",
                     x_scale: Optional[torch.Tensor] = None,
                     noise_std: float = 0.0,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """INT8 conv via integer accumulate, NHWC/HWIO."""
    qx = quantize_act(x, x_scale)
    qw = quantize_weight(w, channel_axis=-1)
    pads = L.conv_pads(x.shape[1], x.shape[2], w.shape[0], stride, padding)
    acc = ref.conv2d_acc(qx.q, qw.q, stride, pads)
    return _dequant_acc(acc, qx.scale, qw.scale, b, noise_std, generator)


# ---------------------------------------------------------------------------
# whole-model PTQ calibration
# ---------------------------------------------------------------------------

def calibrate_resnet(params: Dict, x: torch.Tensor, cfg: dict) -> Dict[str, float]:
    """Record per-layer input activation scales on a calibration batch by
    replaying the reference forward pass.  Like the reference it also
    records an ``"fc"`` scale, which the executor's MVM node does not use
    (it scales the fc input by its own batch)."""
    scales: Dict[str, float] = {}

    def rec(name, t):
        scales[name] = float(act_scale(t))

    rec("stem", x)
    h = L.conv2d(params["stem"], x, stride=1, act="relu")
    for si, blocks in enumerate(params["stages"]):
        for bi, block in enumerate(blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            identity = h
            rec(f"s{si}b{bi}.conv1", h)
            y = L.conv2d(block["conv1"], h, stride=stride, act="relu")
            rec(f"s{si}b{bi}.conv2", y)
            y = L.conv2d(block["conv2"], y, stride=1, act=None)
            if "down" in block:
                rec(f"s{si}b{bi}.down", identity)
                identity = L.conv2d(block["down"], identity, stride=stride,
                                    act=None)
            h = torch.relu(y + identity)
    rec("fc", L.global_avg_pool(h))
    return scales
