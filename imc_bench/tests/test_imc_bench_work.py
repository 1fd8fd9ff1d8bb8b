"""The frozen work counts and weight shapes are held to the port's graphs
and parameter trees as they stand."""

import json
from pathlib import Path

import pytest
import torch

from imc_bench import spec, work

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = ("resnet18-cifar-int8", "yolov8n-f32")


def _config(name):
    return (json.loads((ROOT / "imc_bench" / "configs" / f"{name}.json").read_text()),
            spec.load_module(ROOT / "imc_bench" / "reference" / f"{name}.py"))


def _port_graph(name):
    from repro_torch.models.cnn import graphs
    return graphs.resnet18_graph() if name.startswith("resnet") else graphs.yolov8n_graph()


@pytest.mark.parametrize("name,ops", [("resnet18-cifar-int8", 278_598_656),
                                      ("yolov8n-f32", 8_743_987_200)])
def test_operations_a_frame(name, ops):
    from repro_torch.core.graph import OpKind
    cfg, ref = _config(name)
    g = _port_graph(name)
    assert sum(n.flops for n in g.nodes.values()
               if n.kind in (OpKind.CONV, OpKind.MVM)) == ops
    assert ref.ops_per_frame(cfg) == ops == cfg["ops_per_frame"]


@pytest.mark.parametrize("name", CONFIGS)
def test_conv_shapes_follow_the_port_graph(name):
    """(H, W, Cin, Cout, k, stride) of every conv, as the graph's nodes give
    them, in the graph's order."""
    cfg, ref = _config(name)
    g = _port_graph(name)
    want = []
    for nid in g.topo_order():
        n = g.nodes[nid]
        if n.kind.value != "conv":
            continue
        m = n.meta
        k, s = m["k"], m["stride"]
        ho, wo = m["out_hw"]
        want.append((4, ho * s, wo * s, m["cin_kk"] // (k * k), m["cout"], k, s,
                     m["padding"]))
    got = ref.conv_shapes(cfg, 4)
    if name.startswith("yolo"):   # the graph orders the head's branches apart
        got, want = sorted(got), sorted(want)
    assert got == want


def test_the_conv_bound_of_a_256_frame_request():
    cfg, ref = _config("resnet18-cifar-int8")
    assert cfg["peak_ops_per_s"] == 1979e12 and cfg["hbm_bytes_per_s"] == 3.35e12
    least = sum(work.bound_s(*work.conv_work(s), cfg["peak_ops_per_s"],
                             cfg["hbm_bytes_per_s"])
                for s in ref.conv_shapes(cfg, 256))
    assert least * 1e3 == pytest.approx(0.1224, abs=5e-5)


def test_mvm_work_counts_the_fc():
    assert work.mvm_work(256, 256, 10, True) == (
        256 * 256 + 256 * 10 + 4 + 80 + 4 * 256 * 10, 2 * 256 * 256 * 10)


def _shapes(tree):
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape)
    if hasattr(tree, "shape") and hasattr(tree, "std"):
        return tuple(tree.shape)
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return [_shapes(v) for v in tree]


@pytest.mark.parametrize("name", CONFIGS)
def test_weight_shapes_are_the_port_tree(name):
    cfg, ref = _config(name)
    if name.startswith("resnet"):
        from repro_torch.models.cnn import resnet
        port = resnet.init(torch.Generator().manual_seed(0), resnet.RESNET18_CIFAR,
                           device="meta")
    else:
        from repro_torch.models.cnn import yolo
        port = yolo.init(torch.Generator().manual_seed(0), device="meta")
    assert _shapes(ref.param_shapes(cfg)) == _shapes(port)
    n = sum(torch.Size(s).numel() for s in _flat(_shapes(port)))
    assert n == cfg["parameters"]


def _flat(t):
    if isinstance(t, tuple):
        return [t]
    vals = t.values() if isinstance(t, dict) else t
    return [s for v in vals for s in _flat(v)]


def test_weights_are_one_draw_scaled_per_leaf():
    from imc_bench import weights
    tree = {"a": weights.Leaf((3, 4), 2.0), "b": [weights.Leaf((5,), 0.5)]}
    got = weights.make(tree, torch.Generator().manual_seed(7))
    flat = torch.randn(17, generator=torch.Generator().manual_seed(7))
    assert torch.equal(got["a"], flat[:12].view(3, 4) * 2.0)
    assert torch.equal(got["b"][0], flat[12:] * 0.5)
    again = weights.make(tree, torch.Generator().manual_seed(7))
    assert torch.equal(again["a"], got["a"])
