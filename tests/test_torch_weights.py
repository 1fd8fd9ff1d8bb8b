"""``repro_torch.weights.from_jax_params`` carries the reference's parameter
trees across exactly: the LM trees (bf16 leaves compared as their 16-bit
patterns, the reference's NamedTuples as the port's NamedTuples of the
same name, layers stacked on a leading (L, ...) axis) and the CNN trees.
The port's own ``init_params`` builds the same tree as the reference's."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jget_config
from repro.models.cnn import resnet as jresnet
from repro.models.lm import attention as jattention
from repro.models.lm import transformer as jtransformer
from repro_torch.configs import all_archs, get_config
from repro_torch.models.lm import attention, mlp, transformer
from repro_torch.weights import from_jax_params

ARCHS = ["gemma3-1b", "stablelm-1.6b", "starcoder2-3b", "gemma2-27b"]


def _bits(x) -> np.ndarray:
    """A leaf's raw bits, so that equality is bit equality (NaNs too)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.uint8)
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a.view(np.uint8)


def _assert_same_tree(jtree, ttree, path="params"):
    if isinstance(jtree, dict):
        assert isinstance(ttree, dict) and ttree.keys() == jtree.keys(), path
        for k in jtree:
            _assert_same_tree(jtree[k], ttree[k], f"{path}[{k!r}]")
    elif isinstance(jtree, tuple) and hasattr(jtree, "_fields"):
        assert type(ttree).__name__ == type(jtree).__name__, path
        assert type(ttree).__module__.startswith("repro_torch."), path
        assert ttree._fields == jtree._fields, path
        for f in jtree._fields:
            _assert_same_tree(getattr(jtree, f), getattr(ttree, f), f"{path}.{f}")
    elif isinstance(jtree, (list, tuple)):
        assert type(ttree) is type(jtree) and len(ttree) == len(jtree), path
        for i, (a, b) in enumerate(zip(jtree, ttree)):
            _assert_same_tree(a, b, f"{path}[{i}]")
    else:
        assert isinstance(ttree, torch.Tensor), path
        assert tuple(ttree.shape) == tuple(np.shape(jtree)), path
        assert str(ttree.dtype).split(".")[-1] == np.asarray(jtree).dtype.name, path
        np.testing.assert_array_equal(_bits(ttree), _bits(jtree), err_msg=path)


def _smoke(arch):
    return jget_config(arch).smoke()


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_tree_bit_exact(arch):
    cfg = _smoke(arch)
    jparams = jtransformer.init_params(cfg, jax.random.PRNGKey(0))
    params = from_jax_params(jparams, device="cpu")
    _assert_same_tree(jparams, params)
    seg = params["segments"][0]
    n = cfg.segments[0].n
    assert isinstance(seg["attn"], attention.AttnParams)
    assert isinstance(seg["ffn"], mlp.PlainMLP if cfg.mlp_kind == "plain"
                      else mlp.GatedMLP)
    assert seg["attn"].wq.shape == (n, cfg.d_model, cfg.n_heads, cfg.hd)
    assert seg["norm1"].shape == (n, cfg.d_model)
    assert params["embed"].dtype == torch.bfloat16


def test_gemma3_six_layer_stack():
    """The 6-layer smoke (one window period) keeps its layer axis."""
    cfg = _smoke("gemma3-1b")
    cfg = dataclasses.replace(
        cfg, segments=(dataclasses.replace(cfg.segments[0], n=6),))
    jparams = jtransformer.init_params(cfg, jax.random.PRNGKey(3))
    params = from_jax_params(jparams, device="cpu")
    _assert_same_tree(jparams, params)
    assert params["segments"][0]["ffn"].w_down.shape == (6, cfg.d_ff, cfg.d_model)


def test_bf16_special_values_kept():
    vals = np.array([0.0, -0.0, 1.0, -2.5, 3.0e38, 1e-40, np.inf, -np.inf,
                     np.nan], np.float32)
    j = jnp.asarray(vals).astype(jnp.bfloat16)
    t = from_jax_params(j, device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(t), _bits(j))


def test_kv_cache_carried():
    cache = jattention.init_cache(2, 8, 1, 16)
    t = from_jax_params(cache, device="cpu")
    assert isinstance(t, attention.KVCache) and t.k.shape == (2, 8, 1, 16)


def test_unknown_namedtuple_raises():
    from typing import NamedTuple

    class Mystery(NamedTuple):
        a: np.ndarray

    with pytest.raises(TypeError, match="Mystery"):
        from_jax_params({"x": Mystery(np.zeros(2))}, device="cpu")


@pytest.mark.parametrize("name", ["RESNET8", "RESNET18_CIFAR"])
def test_cnn_tree_round_trip(name):
    jparams = jresnet.init(jax.random.PRNGKey(0), getattr(jresnet, name))
    params = from_jax_params(jparams, device="cpu")
    _assert_same_tree(jparams, params)


def _shapes(tree):
    """A tree's structure with (shape, dtype name) leaves."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree).__name__, tree._fields, [_shapes(v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape), str(tree.dtype).split(".")[-1]


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_builds_the_reference_tree(arch):
    """Same structure, shapes and dtypes as the reference's init (shapes
    only: no values are drawn), and the same parameter count at full
    size."""
    cfg = _smoke(arch)
    jshapes = jax.eval_shape(lambda k: jtransformer.init_params(cfg, k),
                             jax.random.PRNGKey(0))
    tparams = transformer.init_params(get_config(arch).smoke(),
                                      torch.Generator(), device="meta")
    assert _shapes(tparams) == _shapes(jshapes)
    assert transformer.param_count(get_config(arch)) == \
        jtransformer.param_count(jget_config(arch))


def test_registry_holds_the_dense_archs():
    assert all_archs() == sorted(ARCHS)
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget_config(arch))
    with pytest.raises(KeyError, match="ROADMAP"):
        get_config("qwen3-moe-235b-a22b")
    with pytest.raises(KeyError, match="unknown"):
        get_config("no-such-arch")
