"""The port's ResNet models and graph executor against the JAX package:
float forward, INT8 execution with the same calibration scales,
calibration itself and parameter counts.  Parameters come from the JAX
``init`` through ``weights.from_jax_params``; inputs from numpy."""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np

from repro.models import quant as jquant
from repro.models.cnn import executor as jexecutor
from repro.models.cnn import graphs as jgraphs
from repro.models.cnn import resnet as jresnet
from repro.models.cnn.layers import count_params
from repro_torch.models import quant
from repro_torch.models.cnn import executor, graphs, resnet
from repro_torch.weights import from_jax_params

CFGS = {"resnet8": (resnet.RESNET8, jresnet.RESNET8),
        "resnet18": (resnet.RESNET18_CIFAR, jresnet.RESNET18_CIFAR)}


@pytest.fixture(scope="module", params=sorted(CFGS))
def model(request):
    cfg, jcfg = CFGS[request.param]
    jparams = jresnet.init(jax.random.PRNGKey(0), jcfg)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    return cfg, jcfg, params, jparams, x


def test_weights_carry_structure_and_layout(model):
    cfg, _, params, jparams, _ = model
    flat = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in flat:
        node = params
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        assert node.dtype == torch.float32 and node.device.type == "cpu"
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert len(flat) == len(jax.tree_util.tree_leaves(jparams))


def test_float_forward_and_executor_match_reference(model):
    cfg, jcfg, params, jparams, x = model
    want = np.asarray(jresnet.forward(jparams, jnp.asarray(x), jcfg))
    got = resnet.forward(params, torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    g = graphs.build_resnet_graph(cfg)
    got_g = executor.execute(g, params, torch.from_numpy(x), mode="float").numpy()
    np.testing.assert_allclose(got_g, want, rtol=1e-4, atol=1e-4)


def test_calibration_scales_match_reference(model):
    cfg, jcfg, params, jparams, x = model
    want = jquant.calibrate_resnet(jparams, jnp.asarray(x), jcfg)
    got = quant.calibrate_resnet(params, torch.from_numpy(x), cfg)
    assert list(got) == list(want)
    assert "fc" in got            # recorded, though the MVM node ignores it
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("calibrated", [True, False])
def test_int8_executor_matches_reference(model, calibrated):
    cfg, jcfg, params, jparams, x = model
    scales = (jquant.calibrate_resnet(jparams, jnp.asarray(x), jcfg)
              if calibrated else None)
    want = np.asarray(jexecutor.execute(
        jgraphs.build_resnet_graph(jcfg), jparams, jnp.asarray(x), mode="int8",
        act_scales=scales))
    got = executor.execute(graphs.build_resnet_graph(cfg), params,
                           torch.from_numpy(x), mode="int8",
                           act_scales=scales).numpy()
    assert got.shape == want.shape == (2, cfg["num_classes"])
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_int8_ignores_fc_scale(model):
    """The reference's MVM branch never reads act_scales["fc"]."""
    cfg, _, params, _, x = model
    g = graphs.build_resnet_graph(cfg)
    scales = quant.calibrate_resnet(params, torch.from_numpy(x), cfg)
    a = executor.execute(g, params, torch.from_numpy(x), mode="int8",
                         act_scales=scales)
    b = executor.execute(g, params, torch.from_numpy(x), mode="int8",
                         act_scales={**scales, "fc": 123.0})
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_num_params_match_reference(name):
    cfg, jcfg = CFGS[name]
    assert resnet.num_params(cfg) == jresnet.num_params(jcfg)
    assert resnet.num_params(cfg) == count_params(
        jresnet.init(jax.random.PRNGKey(0), jcfg))


def test_init_is_seeded_and_device_independent():
    cfg = resnet.RESNET8
    a = resnet.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    b = resnet.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    c = resnet.init(torch.Generator().manual_seed(1), cfg, device="cpu")
    assert torch.equal(a["stages"][1][0]["down"]["w"], b["stages"][1][0]["down"]["w"])
    assert not torch.equal(a["stem"]["w"], c["stem"]["w"])
    assert a["stages"][1][0]["conv1"]["w"].shape == (3, 3, 16, 32)


def test_unknown_mode_raises():
    with pytest.raises(ValueError):
        executor.execute(graphs.resnet8_graph(), {}, torch.zeros(1), mode="int4")
