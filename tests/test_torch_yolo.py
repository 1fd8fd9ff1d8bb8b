"""The port's YOLOv8n against the JAX package's: the deployment graph
(byte-equal JSON, the paper's node counts), the parameter count and
tree, the four layers YOLOv8n adds (max and average pooling, nearest
upsampling, softmax) and the forward pass, raw and decoded, on reference
parameters carried over with ``weights.from_jax_params``."""

import inspect
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.models.cnn import graphs as jgraphs  # noqa: E402
from repro.models.cnn import layers as jlayers  # noqa: E402
from repro.models.cnn import yolo as jyolo  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.core.graph import OpKind  # noqa: E402
from repro_torch.models.cnn import graphs, layers, yolo  # noqa: E402

HW, BATCH = 64, 2
OUT_RTOL = 1e-4        # max |port - reference| <= OUT_RTOL * max |out|


@pytest.fixture(scope="module")
def ref_run():
    """Reference parameters (``init`` under ``jax.jit``: eager init takes
    tens of seconds on a CPU), a seeded input and the reference's raw and
    decoded outputs, computed once for the module."""
    params = jax.jit(jyolo.init)(jax.random.PRNGKey(0))
    x = np.random.default_rng(0).standard_normal((BATCH, HW, HW, 3)).astype(
        np.float32)
    raw = jax.jit(lambda p, x: jyolo.forward(p, x, decode=False))(params, x)
    dec = jax.jit(lambda p, x: jyolo.forward(p, x, decode=True))(params, x)
    return params, x, [np.asarray(r) for r in raw], np.asarray(dec)


# ---------------------------------------------------------------------------
# deployment graph and parameters
# ---------------------------------------------------------------------------

def test_graph_json_equals_reference():
    assert graphs.yolov8n_graph().to_json() == jgraphs.yolov8n_graph().to_json()


def test_graph_node_counts():
    g = graphs.yolov8n_graph()
    counts = Counter(n.kind.value for n in g.nodes.values())
    assert len(g) == 233
    assert counts == {"conv": 63, "mul": 59, "act": 58, "concat": 19,
                      "split": 11, "add": 10, "reshape": 6, "pool_max": 3,
                      "upsample": 2, "softmax": 1, "mvm": 1}
    conv_flops = sum(n.flops for n in g.nodes.values() if n.kind == OpKind.CONV)
    assert conv_flops == 8_742_912_000.0       # per 640x640 frame
    assert graphs.TABLE1_IMC_NODE_IDS == jgraphs.TABLE1_IMC_NODE_IDS


def test_graph_follows_image_size():
    cfg = {**yolo.YOLOV8N, "image_hw": (HW, HW)}
    assert (graphs.build_yolov8n_graph(cfg).to_json()
            == jgraphs.build_yolov8n_graph(cfg).to_json())


def test_num_params():
    assert yolo.num_params() == 3_151_888


def test_param_tree_matches_reference(ref_run):
    """Same keys, list lengths and leaf shapes: ``from_jax_params`` of a
    reference tree is a tree the port's ``forward`` takes."""
    params = yolo.init(torch.Generator().manual_seed(0), device="meta")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    assert shapes(params) == shapes(ref_run[0])
    assert layers.count_params(params) == jlayers.count_params(ref_run[0])


def test_init_is_seeded_and_defaults_to_the_card():
    a = yolo.init(torch.Generator().manual_seed(0), device="cpu")
    b = yolo.init(torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(a["head"]["cv3"][2]["2"]["w"], b["head"]["cv3"][2]["2"]["w"])
    assert torch.equal(a["b8"]["m"][0]["cv2"]["w"], b["b8"]["m"][0]["cv2"]["w"])
    assert inspect.signature(yolo.init).parameters["device"].default == "cuda"


# ---------------------------------------------------------------------------
# the layers YOLOv8n adds
# ---------------------------------------------------------------------------

def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("hw,k,stride,padding", [
    ((7, 9), 5, 1, "SAME"),      # SPPF's pool at odd sizes
    ((7, 9), 3, 2, "SAME"),      # pads on the bottom/right only
    ((6, 5), 2, None, "SAME"),
    ((9, 7), 3, 2, "VALID"),
    ((11, 11), 5, 3, "SAME"),
])
def test_max_pool_equals_reference(hw, k, stride, padding):
    x = _x((2, *hw, 5)) - 4.0           # all negative: a zero pad would win
    want = np.asarray(jlayers.max_pool(jnp.asarray(x), k, stride, padding))
    got = layers.max_pool(torch.from_numpy(x), k, stride, padding)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hw,k,stride,padding", [
    ((8, 8), 2, None, "VALID"),
    ((7, 9), 3, 2, "VALID"),
    ((7, 9), 3, 1, "SAME"),      # divides by k * k at the padded border
    ((9, 7), 3, 2, "SAME"),
])
def test_avg_pool_equals_reference(hw, k, stride, padding):
    x = _x((2, *hw, 5))
    want = np.asarray(jlayers.avg_pool(jnp.asarray(x), k, stride, padding))
    got = layers.avg_pool(torch.from_numpy(x), k, stride, padding)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("factor", [2, 3])
def test_upsample_nearest_equals_reference(factor):
    x = _x((2, 3, 5, 4))
    want = np.asarray(jlayers.upsample_nearest(jnp.asarray(x), factor))
    got = layers.upsample_nearest(torch.from_numpy(x), factor)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("axis", [-1, 1])
def test_softmax_equals_reference(axis):
    x = 10.0 * _x((3, 7, 16))
    want = np.asarray(jlayers.softmax(jnp.asarray(x), axis))
    got = layers.softmax(torch.from_numpy(x), axis)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def test_forward_raw_equals_reference(ref_run):
    """Measured: max |d| 3.4e-7 against max |raw| 0.354 (1e-6 of it)."""
    params, x, raw, _ = ref_run
    got = yolo.forward(weights.from_jax_params(params, device="cpu"),
                       torch.from_numpy(x), decode=False)
    assert [tuple(g.shape) for g in got] == [r.shape for r in raw] == [
        (BATCH, HW // s, HW // s, 4 * yolo.REG_MAX + yolo.NC)
        for s in yolo.STRIDES]
    for g, r in zip(got, raw):
        assert np.abs(g.numpy() - r).max() <= OUT_RTOL * np.abs(r).max()


def test_forward_decoded_equals_reference(ref_run):
    """Measured: max |d| 9.2e-5 against max |out| 480 (1.9e-7 of it)."""
    params, x, _, dec = ref_run
    got = yolo.forward(weights.from_jax_params(params, device="cpu"),
                       torch.from_numpy(x))
    anchors = sum((HW // s) ** 2 for s in yolo.STRIDES)
    assert tuple(got.shape) == dec.shape == (BATCH, anchors, 4 + yolo.NC)
    assert np.abs(got.numpy() - dec).max() <= OUT_RTOL * np.abs(dec).max()
    # class scores are sigmoids, box widths/heights positive
    assert ((got[..., 4:] > 0) & (got[..., 4:] < 1)).all()
    assert (got[..., 2:4] > 0).all()


def test_constants_equal_reference():
    assert (yolo.CH, yolo.NC, yolo.REG_MAX, yolo.STRIDES, yolo.YOLOV8N) == (
        jyolo.CH, jyolo.NC, jyolo.REG_MAX, jyolo.STRIDES, jyolo.YOLOV8N)
