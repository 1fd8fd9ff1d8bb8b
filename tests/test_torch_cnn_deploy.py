"""The INT8 CNN request as a weight-stationary deployment, on the CPU.

``executor.program_int8`` quantizes each CONV/MVM node's weight once and
``executor.run_int8`` streams batches with that state; ``execute(...,
mode="int8")`` is the two in one call.  Held here:

* program-then-run is ``torch.equal`` to ``execute`` and within
  ``tests/test_torch_executor.py``'s tolerance of the reference's
  ``executor.execute`` (max |d| <= 1e-4 of max |logit|, top-1 equal), for
  ResNet-8 and ResNet-18-CIFAR, with and without calibrated scales;
* over three requests each weight is quantized once, and no weight is
  packed for the kernel on the CPU;
* the request path reads no value on the host (what lets the card replay
  it from a CUDA graph);
* ``GraphedExecute`` refuses parameters off the card and a parameter tree
  other than its own, and keeps the launch counts meaning "launches that
  ran": checked with stand-ins for the CUDA graph machinery and for the
  kernels, since a capture needs the card;
* the conv launcher's check of a pre-packed weight, and the no-copy scale
  and bias arguments the captured launches read.
"""

import contextlib

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import quant as jquant
from repro.models.cnn import executor as jexecutor
from repro.models.cnn import graphs as jgraphs
from repro.models.cnn import resnet as jresnet
from repro_torch.core.graph import OpKind
from repro_torch.kernels import conv2d, ops
from repro_torch.kernels.conv2d import imc_conv2d
from repro_torch.kernels.imc_mvm import channel_vector, device_scalar, imc_mvm
from repro_torch.models import quant
from repro_torch.models.cnn import executor, graphs, resnet
from repro_torch.tree import tree_map
from repro_torch.weights import from_jax_params

CFGS = {"resnet8": (resnet.RESNET8, jresnet.RESNET8),
        "resnet18": (resnet.RESNET18_CIFAR, jresnet.RESNET18_CIFAR)}
B = 4


@pytest.fixture(scope="module", params=sorted(CFGS))
def model(request):
    cfg, jcfg = CFGS[request.param]
    jparams = jresnet.init(jax.random.PRNGKey(0), jcfg)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    x = np.random.default_rng(1).standard_normal((B, 32, 32, 3)).astype(
        np.float32)
    return cfg, jcfg, params, jparams, x


def _torch_model(name, seed=0):
    cfg = CFGS[name][0]
    params = resnet.init(torch.Generator().manual_seed(seed), cfg, device="cpu")
    return cfg, graphs.build_resnet_graph(cfg), params


def _xs(n, seed=2):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, 32, 32, 3)).astype(
        np.float32)) for _ in range(n)]


def _n_weighted(g):
    return g.num_nodes(OpKind.CONV) + g.num_nodes(OpKind.MVM)


@pytest.mark.parametrize("calibrated", [True, False])
def test_program_then_run_is_execute_and_the_reference(model, calibrated):
    cfg, jcfg, params, jparams, x = model
    scales = (jquant.calibrate_resnet(jparams, jnp.asarray(x), jcfg)
              if calibrated else None)
    g = graphs.build_resnet_graph(cfg)
    xt = torch.from_numpy(x)
    got = executor.run_int8(g, executor.program_int8(g, params, scales), xt)
    assert torch.equal(got, executor.execute(g, params, xt, mode="int8",
                                             act_scales=scales))
    want = np.asarray(jexecutor.execute(
        jgraphs.build_resnet_graph(jcfg), jparams, jnp.asarray(x), mode="int8",
        act_scales=scales))
    got = got.numpy()
    assert got.shape == want.shape == (B, cfg["num_classes"])
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("name", sorted(CFGS))
def test_program_holds_each_nodes_fixed_state(name):
    """One entry a CONV/MVM node: the weight quantized as ``quant`` does,
    the bias, the calibrated scale as a () f32 tensor on the parameters'
    device (none for the fc node, whatever ``act_scales`` holds), and no
    packed weight on the CPU."""
    cfg, g, params = _torch_model(name)
    scales = quant.calibrate_resnet(params, _xs(1)[0], cfg)
    assert "fc" in scales
    state = executor.program_int8(g, params, scales)
    weighted = {nid for nid, n in g.nodes.items()
                if n.kind in (OpKind.CONV, OpKind.MVM)}
    assert set(state) == weighted and len(state) == _n_weighted(g)
    for nid, st in state.items():
        node = g.nodes[nid]
        p = executor._param_at(params, node.meta["param"])
        qw = quant.quantize_weight(p["w"])
        assert torch.equal(st.qw.q, qw.q) and torch.equal(st.qw.scale, qw.scale)
        assert st.bias is p["b"] and st.packed is None
        if node.kind == OpKind.MVM:
            assert st.x_scale is None
            continue
        assert st.x_scale.shape == () and st.x_scale.dtype == torch.float32
        assert st.x_scale.device == p["w"].device
        assert st.x_scale.item() == np.float32(scales[node.name])
    assert all(st.x_scale is None for st in
               executor.program_int8(g, params, None).values())


@pytest.mark.parametrize("name", sorted(CFGS))
def test_weights_quantized_once_per_deployment(name, monkeypatch):
    """Three requests through one programmed state: ``quantize_weight``
    runs once a CONV/MVM node (21 for ResNet-18), ``pack_weight`` never on
    the CPU, and each request equals ``execute``'s."""
    cfg, g, params = _torch_model(name)
    xs = _xs(3)
    scales = quant.calibrate_resnet(params, xs[0], cfg)
    want = [executor.execute(g, params, x, mode="int8", act_scales=scales)
            for x in xs]
    calls = {"quantize_weight": 0, "pack_weight": 0}

    def counted(mod, fn_name):
        fn = getattr(mod, fn_name)

        def call(*args, **kwargs):
            calls[fn_name] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(mod, fn_name, call)
    counted(quant, "quantize_weight")
    counted(conv2d, "pack_weight")
    state = executor.program_int8(g, params, scales)
    got = [executor.run_int8(g, state, x) for x in xs]
    assert calls == {"quantize_weight": _n_weighted(g), "pack_weight": 0}
    assert _n_weighted(g) == {"resnet8": 10, "resnet18": 21}[name]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


class _NoHostReads(TorchDispatchMode):
    """Fails on any op that copies a tensor's value to the host
    (``item()``, ``int()``, ``float()``, ``tolist()``)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("the request read a value on the host")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("calibrated", [True, False])
def test_the_request_reads_no_value_on_the_host(calibrated):
    cfg, g, params = _torch_model("resnet18")
    x = _xs(1)[0]
    scales = quant.calibrate_resnet(params, x, cfg) if calibrated else None
    state = executor.program_int8(g, params, scales)
    with _NoHostReads():
        y = executor.run_int8(g, state, x)
    assert y.shape == (B, cfg["num_classes"]) and torch.isfinite(y).all()
    with pytest.raises(AssertionError, match="on the host"), _NoHostReads():
        executor.run_int8(g, state, x).max().item()


def test_graphed_execute_refuses_parameters_off_the_card():
    """No quiet fallback: ``GraphedExecute`` refuses CPU parameters, and
    the served request (``int8_request``) on the CPU is ``execute``."""
    cfg, g, params = _torch_model("resnet8")
    with pytest.raises(ValueError, match="the CPU's path is execute"):
        executor.GraphedExecute(g, params)
    x = _xs(1)[0]
    scales = quant.calibrate_resnet(params, x, cfg)
    request = executor.int8_request(g, params, scales)
    assert not isinstance(request, executor.GraphedExecute)
    assert torch.equal(request(params, x), executor.execute(
        g, params, x, mode="int8", act_scales=scales))


class _StandInGraph:
    """``torch.cuda.CUDAGraph`` as a capture on the CPU leaves it: the
    "captured" run has computed the static output, a replay counts (or
    fails as a replay of PyTorch's does)."""
    fail = False

    def __init__(self):
        self.replays = 0

    def replay(self):
        if self.fail:
            raise RuntimeError("replay failed")
        self.replays += 1


class _StandInStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def stand_ins(monkeypatch):
    """The CUDA graph machinery, the card check and the kernels' counts
    stood in for on the CPU: each INT8 op counts a launch on the instance
    the rule names, as the wrappers do on the card."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, stream=None:
                        contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda device=None: _StandInStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _StandInStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(executor, "_card_of", lambda params: torch.device("cpu"))
    for fn in (imc_conv2d, imc_mvm):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "launches_by_instance",
                            dict.fromkeys(fn.launches_by_instance, 0))
    conv, mvm = ops.quantized_conv2d, ops.quantized_matmul

    def counted_conv(qx, qw, *args, **kwargs):
        imc_conv2d.launches += 1
        imc_conv2d.launches_by_instance[conv2d.conv_instance(
            qx.shape[3], qw.shape[3], qx.data_ptr() % 16 == 0)] += 1
        return conv(qx, qw, *args, **kwargs)

    def counted_mvm(qx, qw, *args, **kwargs):
        imc_mvm.launches += 1
        imc_mvm.launches_by_instance["cp_async"] += 1
        return mvm(qx, qw, *args, **kwargs)
    monkeypatch.setattr(ops, "quantized_conv2d", counted_conv)
    monkeypatch.setattr(ops, "quantized_matmul", counted_mvm)


def _counts():
    return (imc_conv2d.launches, dict(imc_conv2d.launches_by_instance),
            imc_mvm.launches, dict(imc_mvm.launches_by_instance))


def test_graphed_counts_add_the_captured_launches_on_each_replay(stand_ins):
    """The warm-up's launches ran and stay counted; the capture's were only
    recorded and are taken back; each replay adds them.  One graph a
    (shape, dtype); a call returns a copy of the static logits."""
    cfg, g, params = _torch_model("resnet8")
    xs = _xs(3)
    scales = quant.calibrate_resnet(params, xs[0], cfg)
    want = executor.execute(g, params, xs[0], mode="int8", act_scales=scales)
    for fn in (imc_conv2d, imc_mvm):
        fn.launches = 0
        fn.launches_by_instance = dict.fromkeys(fn.launches_by_instance, 0)
    graphed = executor.GraphedExecute(g, params, scales)
    y0 = graphed(params, xs[0])
    n_conv, n_mvm = g.num_nodes(OpKind.CONV), g.num_nodes(OpKind.MVM)
    by_conv = dict.fromkeys(imc_conv2d.launches_by_instance, 0)
    for nid, node in g.nodes.items():
        if node.kind == OpKind.CONV:
            w = executor._param_at(params, node.meta["param"])["w"]
            by_conv[conv2d.conv_instance(w.shape[2], w.shape[3], True)] += 1
    per_request = (n_conv, by_conv, n_mvm, {"cp_async": n_mvm, "gather": 0})

    def times(k):
        return (k * n_conv, {i: k * v for i, v in by_conv.items()},
                k * n_mvm, {"cp_async": k * n_mvm, "gather": 0})
    captured, = graphed.graphs.values()
    assert captured.launches == ((n_conv, by_conv),
                                 (n_mvm, {"cp_async": n_mvm, "gather": 0}))
    assert _counts() == times(2)            # the warm-up and one replay
    assert captured.graph.replays == 1 and len(graphed.capture_seconds) == 1
    assert y0 is not captured.out and y0.data_ptr() != captured.out.data_ptr()
    assert torch.equal(y0, want)
    for x in xs[1:]:
        graphed(params, x)
    assert _counts() == times(4) and captured.graph.replays == 3
    assert len(graphed.graphs) == 1 and per_request == times(1)
    graphed(params, torch.zeros((2, 32, 32, 3)))      # a new key: a new graph
    assert len(graphed.graphs) == 2 and _counts() == times(6)


def test_graphed_refuses_a_foreign_tree_and_raises_on_replay(stand_ins):
    _, g, params = _torch_model("resnet8")
    x = _xs(1)[0]
    graphed = executor.GraphedExecute(g, params)
    other = tree_map(torch.clone, params)
    with pytest.raises(ValueError, match="parameters other"):
        graphed(other, x)
    assert not graphed.graphs and _counts()[0] == 0
    graphed(params, x)
    before = _counts()
    _StandInGraph.fail = True
    try:
        with pytest.raises(RuntimeError, match="replay failed"):
            graphed(params, x)
    finally:
        _StandInGraph.fail = False
    assert _counts() == before


def test_conv_launcher_checks_a_packed_weight():
    gen = torch.Generator().manual_seed(0)
    qw = torch.randint(-127, 128, (3, 3, 5, 7), generator=gen,
                       dtype=torch.int8)
    wp = conv2d.pack_weight(qw)
    assert wp.shape == (7, 16) and wp.dtype == torch.int32   # Kpad 64 of 45
    conv2d.check_packed(wp, qw, qw.device)
    for bad in (wp.view(torch.int8), wp[:, :15].contiguous(), wp.t(),
                wp.t().contiguous().t(), wp.to("meta")):
        with pytest.raises(ValueError, match="packed weight"):
            conv2d.check_packed(bad, qw, qw.device)


def test_scale_and_bias_arguments_are_not_copied():
    """f32 scales and biases already on the device reach the kernel as they
    are: a captured launch reads the deployment's own tensors."""
    s = torch.full((), 0.25)
    v = torch.randn(8)
    assert device_scalar(s, s.device).data_ptr() == s.data_ptr()
    assert channel_vector(v, 8, v.device).data_ptr() == v.data_ptr()
