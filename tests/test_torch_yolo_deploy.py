"""YOLOv8n's request as a weight-stationary deployment, on the CPU.

``yolo.program`` lays out each conv's weight and builds the decode's
constants once; ``yolo.forward_programmed`` runs a request over that
state; on the card ``yolo.GraphedForward`` replays it from a CUDA graph.
Held here:

* the programmed forward is ``torch.equal`` to ``yolo.forward``, raw and
  decoded, at a square and a non-square image, and within
  ``tests/test_torch_yolo.py``'s tolerance of the reference's forward on
  the reference's parameters (``weights.from_jax_params``);
* the programmed decode constants equal those ``forward`` builds, and
  the reference's, with no conv run;
* ``program`` leaves the parameter tree as it was;
* ``GraphedForward`` refuses parameters off the card and a tree other
  than its own, keeps one graph a (shape, dtype), returns copies that
  later requests do not overwrite, and raises on a failed replay:
  checked with stand-ins for the CUDA graph machinery, since a capture
  needs the card; ``request`` on the CPU is the programmed forward.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.models.cnn import yolo as jyolo  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.models.cnn import yolo  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

BATCH = 2
OUT_RTOL = 1e-4        # max |port - reference| <= OUT_RTOL * max |out|
SIZES = {"64x64": (64, 64), "96x64": (96, 64)}


@pytest.fixture(scope="module")
def ref_params():
    """Reference parameters (``init`` under ``jax.jit``) and the port's
    copy of them."""
    params = jax.jit(jyolo.init)(jax.random.PRNGKey(0))
    return params, weights.from_jax_params(params, device="cpu")


def _x(hw, batch=BATCH, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (batch, *hw, 3)).astype(np.float32)


@pytest.mark.parametrize("size", sorted(SIZES))
def test_programmed_forward_equals_forward_and_reference(size, ref_params):
    jparams, params = ref_params
    hw = SIZES[size]
    x = _x(hw)
    state = yolo.program(params, hw)
    xt = torch.from_numpy(x)
    raw = yolo.forward_programmed(state, xt, decode=False)
    dec = yolo.forward_programmed(state, xt)
    want_raw = yolo.forward(params, xt, decode=False)
    want_dec = yolo.forward(params, xt)
    assert [tuple(r.shape) for r in raw] == [
        (BATCH, -(-hw[0] // s), -(-hw[1] // s), 4 * yolo.REG_MAX + yolo.NC)
        for s in yolo.STRIDES]
    assert all(torch.equal(a, b) for a, b in zip(raw, want_raw))
    assert torch.equal(dec, want_dec)
    ref_raw = jax.jit(lambda p, x: jyolo.forward(p, x, decode=False))(jparams, x)
    ref_dec = np.asarray(jax.jit(jyolo.forward)(jparams, x))
    for got, ref in zip(raw, ref_raw):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= OUT_RTOL * np.abs(ref).max()
    assert dec.shape == ref_dec.shape
    assert np.abs(dec.numpy() - ref_dec).max() <= OUT_RTOL * np.abs(ref_dec).max()


def _reference_constants(scale_hw):
    """The reference forward's anchors, strides and bins, built as its
    decode builds them from the raw outputs' shapes."""
    anchors, strides = [], []
    for (h, w), s in zip(scale_hw, jyolo.STRIDES):
        ys, xs = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
        anchors.append(jnp.stack([xs.reshape(-1) + 0.5,
                                  ys.reshape(-1) + 0.5], -1))
        strides.append(jnp.full((h * w, 1), float(s)))
    return (np.asarray(jnp.concatenate(anchors, axis=0)),
            np.asarray(jnp.concatenate(strides, axis=0)),
            np.asarray(jnp.arange(jyolo.REG_MAX, dtype=jnp.float32)))


@pytest.mark.parametrize("hw", [(64, 64), (640, 640)])
def test_programmed_decode_constants_equal_forwards(hw, monkeypatch):
    """The constants ``program`` builds for an image size equal those
    ``forward`` builds from its raw outputs' shapes (H/s x W/s) and the
    reference's; no conv runs for it."""
    def no_conv(*args, **kwargs):
        raise AssertionError("a conv ran")
    monkeypatch.setattr(torch.nn.functional, "conv2d", no_conv)
    params = yolo.init(torch.Generator().manual_seed(0), device="cpu")
    state = yolo.program(params, hw)
    scales = [(hw[0] // s, hw[1] // s) for s in yolo.STRIDES]
    assert yolo.scale_hw(hw) == scales
    want = yolo.decode_constants(scales, torch.device("cpu"))
    for got, w, ref in zip(state.decode, want, _reference_constants(scales)):
        assert got.dtype == torch.float32
        assert torch.equal(got, w)
        np.testing.assert_array_equal(got.numpy(), ref)
    assert state.decode.anchor.shape == (sum(h * w for h, w in scales), 2)


def test_program_leaves_the_tree_unchanged():
    params = yolo.init(torch.Generator().manual_seed(0), device="cpu")
    leaves = tree_leaves(params)
    before = [t.clone() for t in leaves]
    state = yolo.program(params, (64, 64))
    after = tree_leaves(params)
    assert len(after) == len(before)
    for leaf, now, was in zip(leaves, after, before):
        assert now is leaf and torch.equal(now, was)
    w = params["b2"]["m"][0]["cv1"]["w"]
    pw = state.convs["b2"]["m"][0]["cv1"]["w"]
    assert pw is not w and pw.data_ptr() != w.data_ptr()
    assert torch.equal(pw, w.permute(3, 2, 0, 1))
    assert pw.is_contiguous(memory_format=torch.channels_last)
    n_w = sum(1 for _ in _weights(state.convs))
    assert n_w == 63 and len(leaves) == 2 * 63


def _weights(tree):
    if isinstance(tree, list):
        for v in tree:
            yield from _weights(v)
    elif "w" in tree:
        yield tree["w"]
    else:
        for v in tree.values():
            yield from _weights(v)


def test_programmed_forward_refuses_another_image_size():
    params = yolo.init(torch.Generator().manual_seed(0), device="cpu")
    state = yolo.program(params, (64, 64))
    with pytest.raises(ValueError, match="programmed for"):
        yolo.forward_programmed(state, torch.zeros((1, 96, 64, 3)))


def test_graphed_refuses_cpu_parameters_and_request_on_cpu_is_programmed():
    params = yolo.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="the CPU's path is forward_programmed"):
        yolo.GraphedForward(params, (64, 64))
    request = yolo.request(params, (64, 64))
    assert not isinstance(request, yolo.GraphedForward)
    x = torch.from_numpy(_x((64, 64)))
    state = yolo.program(params, (64, 64))
    assert torch.equal(request(params, x), yolo.forward_programmed(state, x))
    raw = request(params, x, decode=False)
    assert all(torch.equal(a, b) for a, b in
               zip(raw, yolo.forward_programmed(state, x, decode=False)))
    with pytest.raises(ValueError, match="parameters other"):
        request(tree_map(torch.clone, params), x)


class _StandInGraph:
    """``torch.cuda.CUDAGraph`` as a capture on the CPU leaves it: the
    "captured" run has computed the static outputs; a replay counts, runs
    ``rerun`` where a test set one (what a replay of the card's graph
    does: recompute the static outputs from the static input), or fails
    as a replay of PyTorch's does."""
    fail = False

    def __init__(self):
        self.replays = 0
        self.rerun = None

    def replay(self):
        if self.fail:
            raise RuntimeError("replay failed")
        self.replays += 1
        if self.rerun is not None:
            self.rerun()


class _StandInStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def stand_ins(monkeypatch):
    """The CUDA graph machinery and the card check stood in for on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, stream=None:
                        contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda device=None: _StandInStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _StandInStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(yolo, "_card_of", lambda params: torch.device("cpu"))


def _recompute(graphed, c):
    """What a replay of ``c``'s graph computes, into its static outputs."""
    def rerun():
        raw, out = graphed._run(c.x)
        for r, new in zip(c.raw, raw):
            r.copy_(new)
        c.out.copy_(out)
    return rerun


def test_graphed_keeps_one_graph_a_shape_and_returns_copies(stand_ins):
    params = yolo.init(torch.Generator().manual_seed(0), device="cpu")
    xs = [torch.from_numpy(_x((64, 64), seed=s)) for s in range(3)]
    graphed = yolo.GraphedForward(params, (64, 64))
    y0 = graphed(params, xs[0])
    captured, = graphed.graphs.values()
    assert captured.graph.replays == 1 and len(graphed.capture_seconds) == 1
    assert y0 is not captured.out and y0.data_ptr() != captured.out.data_ptr()
    assert torch.equal(y0, yolo.forward(params, xs[0]))
    captured.graph.rerun = _recompute(graphed, captured)
    y1 = graphed(params, xs[1])
    raw2 = graphed(params, xs[2], decode=False)
    assert len(graphed.graphs) == 1 and captured.graph.replays == 3
    assert torch.equal(y0, yolo.forward(params, xs[0]))       # kept
    assert torch.equal(y1, yolo.forward(params, xs[1]))
    assert all(torch.equal(a, b) for a, b in
               zip(raw2, yolo.forward(params, xs[2], decode=False)))
    assert all(r is not s for r, s in zip(raw2, captured.raw))
    y3 = graphed(params, xs[1][:1])                 # a new shape: a new graph
    assert len(graphed.graphs) == 2 and len(graphed.capture_seconds) == 2
    assert torch.equal(y3, yolo.forward(params, xs[1][:1]))
    assert captured.graph.replays == 3


def test_graphed_refuses_a_foreign_tree_and_raises_on_replay(stand_ins):
    params = yolo.init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.from_numpy(_x((64, 64)))
    graphed = yolo.GraphedForward(params, (64, 64))
    with pytest.raises(ValueError, match="parameters other"):
        graphed(tree_map(torch.clone, params), x)
    assert not graphed.graphs and not graphed.capture_seconds
    graphed(params, x)
    _StandInGraph.fail = True
    try:
        with pytest.raises(RuntimeError, match="replay failed"):
            graphed(params, x)
    finally:
        _StandInGraph.fail = False
    assert len(graphed.graphs) == 1
