"""Executable ResNet8 / ResNet18-CIFAR (the paper's §V.A/§V.B workloads).

Counterpart of ``repro.models.cnn.resnet``, with the same configs and the
same parameter tree (``stem``, ``stages[si][bi]{conv1,conv2,down}``,
``fc``).  ResNet18-CIFAR has a 3x3 stem, no maxpool and widths
(32, 64, 128, 256): 2.79M parameters.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import layers as L


RESNET8 = {
    "name": "resnet8",
    "stem_width": 16,
    "stage_widths": (16, 32, 64),
    "blocks_per_stage": (1, 1, 1),
    "num_classes": 10,
    "image_hw": (32, 32),
}

RESNET18_CIFAR = {
    "name": "resnet18_cifar",
    "stem_width": 32,
    "stage_widths": (32, 64, 128, 256),
    "blocks_per_stage": (2, 2, 2, 2),
    "num_classes": 10,
    "image_hw": (32, 32),
}


def init(generator: torch.Generator, cfg: dict, device="cuda") -> Dict:
    """Parameter tree mirroring the block structure.  Draws from
    ``generator`` on the generator's own device and moves the result to
    ``device``, so one CPU generator seed gives the same parameters on
    every device."""
    gen = generator
    params: Dict = {"stem": L.conv_init(gen, 3, 3, cfg["stem_width"], device)}
    cin = cfg["stem_width"]
    stages = []
    for si, (width, nblocks) in enumerate(
        zip(cfg["stage_widths"], cfg["blocks_per_stage"])
    ):
        blocks = []
        for bi in range(nblocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            block = {
                "conv1": L.conv_init(gen, 3, cin, width, device),
                "conv2": L.conv_init(gen, 3, width, width, device),
            }
            if stride != 1 or cin != width:
                block["down"] = L.conv_init(gen, 1, cin, width, device)
            blocks.append(block)
            cin = width
        stages.append(blocks)
    params["stages"] = stages
    params["fc"] = L.dense_init(gen, cin, cfg["num_classes"], device)
    return params


def forward(params: Dict, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """NHWC image batch -> logits."""
    x = L.conv2d(params["stem"], x, stride=1, act="relu")
    for si, blocks in enumerate(params["stages"]):
        for bi, block in enumerate(blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            identity = x
            y = L.conv2d(block["conv1"], x, stride=stride, act="relu")
            y = L.conv2d(block["conv2"], y, stride=1, act=None)
            if "down" in block:
                identity = L.conv2d(block["down"], identity, stride=stride,
                                    act=None)
            x = torch.relu(y + identity)
    x = L.global_avg_pool(x)
    return L.dense(params["fc"], x)


def num_params(cfg: dict) -> int:
    return L.count_params(init(torch.Generator().manual_seed(0), cfg,
                              device="cpu"))
