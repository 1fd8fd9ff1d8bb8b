"""Work counted from shapes, and the card's published peaks.

Frozen copies of the port's arithmetic, so that a later change to the
program cannot move the yardstick: the conv/fc operation count of a
deployment-graph node (``repro_torch.models.cnn.layers.conv_cost`` and
``dense_cost``) and the kernel bench's ``conv_work``/``mvm_work``/``bound``
(``benchmarks_torch/kernel_bench.py``).  A CPU test holds them to the
port's graphs as they stand.  The card's rates (peak operations, HBM
bytes a second) are the configuration's, passed in.
"""

from __future__ import annotations

import math
from typing import Tuple

#: (B, H, W, Cin, Cout, k, stride, padding) of one conv launch
ConvShape = Tuple[int, int, int, int, int, int, int, str]


def conv_out_hw(h: int, w: int, k: int, stride: int,
                padding: str) -> Tuple[int, int]:
    if padding == "SAME":
        return math.ceil(h / stride), math.ceil(w / stride)
    if padding == "VALID":
        return (h - k) // stride + 1, (w - k) // stride + 1
    raise ValueError(f"unknown padding {padding!r}")


def same_pads(h: int, w: int, k: int, stride: int) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) of a SAME ``k`` x ``k`` conv: the total
    split floor/ceil, as XLA and the port do."""
    ho, wo = conv_out_hw(h, w, k, stride, "SAME")
    ph = max((ho - 1) * stride + k - h, 0)
    pw = max((wo - 1) * stride + k - w, 0)
    return ph // 2, ph - ph // 2, pw // 2, pw - pw // 2


def conv_ops(shape: ConvShape) -> int:
    """2 MACs' worth of operations a tap of each output channel."""
    B, H, W, cin, cout, k, s, padding = shape
    ho, wo = conv_out_hw(H, W, k, s, padding)
    return 2 * B * ho * wo * k * k * cin * cout


def conv_work(shape: ConvShape) -> Tuple[int, int]:
    """(bytes, operations) of one INT8 conv launch: int8 x and w, sx, sw
    and the bias read once, the f32 output written once."""
    B, H, W, cin, cout, k, s, padding = shape
    ho, wo = conv_out_hw(H, W, k, s, padding)
    return (B * H * W * cin + k * k * cin * cout + 4 + 8 * cout
            + 4 * B * ho * wo * cout, conv_ops(shape))


def mvm_work(M: int, K: int, N: int, bias: bool) -> Tuple[int, int]:
    """(bytes, operations) of one INT8 (M, K) x (K, N) product: int8 qx and
    qw, the f32 scales (and bias) read once, the f32 output written once."""
    return (M * K + K * N + 4 + 4 * N * (2 if bias else 1) + 4 * M * N,
            2 * M * K * N)


def bound_s(n_bytes: float, n_ops: float, peak: float,
            bytes_per_s: float) -> float:
    """The least time of a launch: its bytes at ``bytes_per_s`` or its
    operations at ``peak``, whichever is longer."""
    return max(n_bytes / bytes_per_s, n_ops / peak)
