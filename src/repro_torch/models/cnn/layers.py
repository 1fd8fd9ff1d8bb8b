"""PyTorch building blocks for the paper's CNN workloads.

Counterpart of ``repro.models.cnn.layers``.  Plain functions on tensors
over a nested parameter tree; layouts are the reference's (NHWC
activations, HWIO weights), so parameters carry across with no
transposes.  BatchNorm is folded into the preceding conv's bias.

SAME padding is applied explicitly and asymmetrically (floor on top/left,
ceil on bottom/right, as XLA does): ``F.conv2d(padding=1)`` is symmetric
and shifts every output of a stride-2 conv.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def _he_normal(generator: torch.Generator, shape, fan_in: int,
               device) -> torch.Tensor:
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * math.sqrt(2.0 / fan_in)).to(device)


def conv_init(generator: torch.Generator, k: int, cin: int, cout: int,
              device="cuda") -> Dict[str, torch.Tensor]:
    """HWIO conv weights + bias (bias holds folded BN offsets)."""
    return {
        "w": _he_normal(generator, (k, k, cin, cout), k * k * cin, device),
        "b": torch.zeros((cout,), dtype=torch.float32, device=device),
    }


def dense_init(generator: torch.Generator, cin: int, cout: int,
               device="cuda") -> Dict[str, torch.Tensor]:
    return {
        "w": _he_normal(generator, (cin, cout), cin, device),
        "b": torch.zeros((cout,), dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# functional ops
# ---------------------------------------------------------------------------

def conv2d(params, x: torch.Tensor, stride: int = 1, padding: str = "SAME",
           act: Optional[str] = None) -> torch.Tensor:
    """Float conv, NHWC x HWIO -> NHWC."""
    w = params["w"]
    top, bottom, left, right = conv_pads(x.shape[1], x.shape[2], w.shape[0],
                                         stride, padding)
    xn = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride)
    y = y.permute(0, 2, 3, 1) + params["b"]
    return activate(y, act)


def dense(params, x: torch.Tensor, act: Optional[str] = None) -> torch.Tensor:
    return activate(x @ params["w"] + params["b"], act)


def activate(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act is None:
        return x
    if act == "relu":
        return torch.relu(x)
    if act == "silu":
        return F.silu(x)
    if act == "sigmoid":
        return torch.sigmoid(x)
    raise ValueError(f"unknown activation {act!r}")


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over H and W.  Summed in float64 and rounded once, so the
    result does not depend on the device's reduction order: the INT8 fc
    node quantizes it, and a last-bit difference there would move a
    rounding boundary."""
    return x.double().mean(dim=(1, 2)).to(x.dtype)


def max_pool(x: torch.Tensor, k: int, stride: Optional[int] = None,
             padding: str = "SAME") -> torch.Tensor:
    """NHWC max pool.  SAME pads with -inf, split floor/ceil as
    ``lax.reduce_window`` does, so a padded cell never wins."""
    stride = stride or k
    top, bottom, left, right = conv_pads(x.shape[1], x.shape[2], k, stride,
                                         padding)
    xn = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom),
               value=-math.inf)
    return F.max_pool2d(xn, k, stride).permute(0, 2, 3, 1)


def avg_pool(x: torch.Tensor, k: int, stride: Optional[int] = None,
             padding: str = "VALID") -> torch.Tensor:
    """NHWC average pool.  SAME pads with zeros and still divides by
    ``k * k``, as the reference's window sum over ``k * k`` does."""
    stride = stride or k
    top, bottom, left, right = conv_pads(x.shape[1], x.shape[2], k, stride,
                                         padding)
    xn = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    return F.avg_pool2d(xn, k, stride).permute(0, 2, 3, 1)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """NHWC nearest-neighbour upsampling by an integer factor."""
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)


def softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.softmax(x, dim=axis)


# ---------------------------------------------------------------------------
# shape/cost bookkeeping shared with the deployment-graph builders
# ---------------------------------------------------------------------------

def conv_out_hw(h: int, w: int, k: int, stride: int, padding: str) -> Tuple[int, int]:
    if padding == "SAME":
        return (math.ceil(h / stride), math.ceil(w / stride))
    # VALID
    return ((h - k) // stride + 1, (w - k) // stride + 1)


def conv_pads(h: int, w: int, k: int, stride: int,
              padding: str) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) zero padding of a ``k`` x ``k`` conv.
    SAME splits the total floor/ceil as XLA does; VALID pads nothing."""
    if padding == "VALID":
        return (0, 0, 0, 0)
    if padding != "SAME":
        raise ValueError(f"unknown padding {padding!r}")
    ho, wo = conv_out_hw(h, w, k, stride, padding)
    ph = max((ho - 1) * stride + k - h, 0)
    pw = max((wo - 1) * stride + k - w, 0)
    return (ph // 2, ph - ph // 2, pw // 2, pw - pw // 2)


def conv_cost(h: int, w: int, k: int, cin: int, cout: int, stride: int,
              padding: str = "SAME") -> dict:
    """FLOPs/bytes/IMC-metadata for one conv node (per single frame)."""
    ho, wo = conv_out_hw(h, w, k, stride, padding)
    macs = ho * wo * k * k * cin * cout
    params = k * k * cin * cout + cout
    return {
        "flops": 2.0 * macs,
        "weight_bytes": float(params),            # INT8 deployment: 1 B/param
        "out_bytes": float(ho * wo * cout),       # INT8 activations
        "out_elems": float(ho * wo * cout),
        "meta": {"cin_kk": k * k * cin, "cout": cout, "n_vectors": ho * wo,
                 "out_hw": (ho, wo)},
    }


def dense_cost(cin: int, cout: int) -> dict:
    return {
        "flops": 2.0 * cin * cout,
        "weight_bytes": float(cin * cout + cout),
        "out_bytes": float(cout),
        "out_elems": float(cout),
        "meta": {"cin_kk": cin, "cout": cout, "n_vectors": 1},
    }


def elem_cost(n_elems: float) -> dict:
    return {
        "flops": float(n_elems),
        "weight_bytes": 0.0,
        "out_bytes": float(n_elems),
        "out_elems": float(n_elems),
        "meta": {},
    }


def count_params(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return sum(count_params(v) for v in tree)
