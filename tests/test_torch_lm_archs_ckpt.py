"""The data pipeline's encoder-frame and image-prefix batches, the new
families' NamedTuples through ``from_jax_params``, and checkpoints of
MoE, SSM, hybrid and encoder-decoder trees read across the two packages
in both directions, against the reference.  Batches and checkpoints are
equal bit for bit (bf16 leaves by their 16-bit patterns), and each
package writes the same leaf names and dtypes."""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jget_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.data import pipeline as jpipeline
from repro.models.lm import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import ckpt
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.data import pipeline
from repro_torch.models.lm import moe, rglru, ssm, transformer
from repro_torch.optim import adamw
from repro_torch.tree import tree_flatten_with_names
from repro_torch.weights import from_jax_params

NEW_ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-235b-a22b", "falcon-mamba-7b",
             "recurrentgemma-9b", "whisper-small", "paligemma-3b"]


# ---------------------------------------------------------------------------
# the data pipeline's encoder-frame and image-prefix batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["whisper-small", "paligemma-3b"])
@pytest.mark.parametrize("hosts,host", [(1, 0), (2, 1)])
def test_make_batch_equals_reference(arch, hosts, host):
    """Bit-equal, bf16 frames and prefixes included, at full width."""
    jc, tc = jget_config(arch), get_config(arch)
    dcfg = pipeline.DataConfig(num_hosts=hosts, host_id=host)
    jdcfg = jpipeline.DataConfig(num_hosts=hosts, host_id=host)
    for step in (0, 3):
        want = jpipeline.make_batch(jc, JShapeSpec("d", 320, 4, "train"), step, jdcfg)
        got = pipeline.make_batch(tc, ShapeSpec("d", 320, 4, "train"), step, dcfg,
                                  device="cpu")
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            w = np.asarray(w)
            g = got[key]
            if w.dtype.name == "bfloat16":
                assert g.dtype == torch.bfloat16
                np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                              w.view(np.int16), err_msg=key)
            else:
                assert g.dtype == torch.int32
                np.testing.assert_array_equal(g.numpy(), w, err_msg=key)


def test_data_iterator_with_frames():
    jc, tc = jget_config("whisper-small").smoke(), get_config("whisper-small").smoke()
    jit = jpipeline.DataIterator(jc, JShapeSpec("d", 64, 2, "train"), start_step=2)
    it = pipeline.DataIterator(tc, ShapeSpec("d", 64, 2, "train"), start_step=2,
                               device="cpu")
    for _ in range(2):
        a, b = next(it), next(jit)
        np.testing.assert_array_equal(a["enc_frames"].float().numpy(),
                                      np.asarray(b["enc_frames"], np.float32))
        np.testing.assert_array_equal(a["tokens"].numpy(), np.asarray(b["tokens"]))


# ---------------------------------------------------------------------------
# parameter trees and checkpoints across the packages
# ---------------------------------------------------------------------------

def test_new_namedtuples_carried():
    for arch, seg_type in (("granite-moe-3b-a800m", moe.MoEParams),
                           ("falcon-mamba-7b", ssm.SSMParams),
                           ("recurrentgemma-9b", rglru.RGLRUParams)):
        jparams = jtransformer.init_params(jget_config(arch).smoke(),
                                           jax.random.PRNGKey(0))
        params = from_jax_params(jparams, "cpu")
        seg = params["segments"][0]
        leaf = {moe.MoEParams: lambda s: s["ffn"],
                ssm.SSMParams: lambda s: s["ssm"],
                rglru.RGLRUParams: lambda s: s["rec1"]["rec"]}[seg_type](seg)
        assert isinstance(leaf, seg_type), arch
        for (n, a), (_, b) in zip(jckpt._flatten_with_names(jparams),
                                  tree_flatten_with_names(params)):
            assert str(b.dtype).split(".")[-1] == np.asarray(a).dtype.name, n
    states = {"ssm": jtransformer.ssm.init_state(2, 16, 4),
              "rec": jtransformer.rglru.init_state(2, 16)}
    got = from_jax_params(states, "cpu")
    assert isinstance(got["ssm"], ssm.SSMState) and \
        isinstance(got["rec"], rglru.RGLRUState)


def _state(arch):
    """A reference training state after one AdamW step."""
    jcfg = jget_config(arch).smoke()
    jparams = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    grads = jax.tree_util.tree_map(lambda p: jnp.ones(p.shape, jnp.float32), jparams)
    jparams, jopt, _ = jadamw.apply(jadamw.AdamWConfig(), jparams,
                                    jadamw.init(jparams), grads)
    return {"params": jparams, "opt": jopt}


def _assert_bits_equal(jtree, ttree):
    jn, tn = jckpt._flatten_with_names(jtree), tree_flatten_with_names(ttree)
    assert [n for n, _ in jn] == [n for n, _ in tn]
    for (name, a), (_, b) in zip(jn, tn):
        a = np.asarray(a)
        assert str(b.dtype).split(".")[-1] == a.dtype.name, name
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                          a.view(np.int16), err_msg=name)
        else:
            np.testing.assert_array_equal(b.numpy(), a, err_msg=name)


ROUND_TRIP = ["granite-moe-3b-a800m", "falcon-mamba-7b", "recurrentgemma-9b",
              "whisper-small"]


@pytest.mark.parametrize("arch", ROUND_TRIP)
def test_checkpoint_reference_to_port(arch, tmp_path):
    jstate = _state(arch)
    jckpt.save(str(tmp_path / "ref"), 5, jstate)
    cfg = get_config(arch).smoke()
    meta = transformer.init_params(cfg, torch.Generator(), device="meta")
    got, _ = ckpt.restore(str(tmp_path / "ref"), 5,
                          {"params": meta, "opt": adamw.init(meta)}, device="cpu")
    _assert_bits_equal(jstate, got)
    ckpt.save(str(tmp_path / "port"), 5, got)
    names = [json.load(open(tmp_path / d / "step_000000005" / "manifest.json"))
             for d in ("ref", "port")]
    assert names[0]["names"] == names[1]["names"]
    assert names[0]["dtypes"] == names[1]["dtypes"]


@pytest.mark.parametrize("arch", ROUND_TRIP)
def test_checkpoint_port_to_reference(arch, tmp_path):
    jstate = _state(arch)
    ckpt.save(str(tmp_path), 2, from_jax_params(jstate, "cpu"))
    step, got, _ = jckpt.restore_latest(str(tmp_path), jstate)
    assert step == 2
    _assert_bits_equal(got, from_jax_params(jstate, "cpu"))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(jstate)


def test_meta_tree_equals_reference_shapes():
    """The port's init on the meta device builds the reference's tree for
    every new family (what a resuming run restores into)."""
    for arch in NEW_ARCHS:
        cfg = jget_config(arch).smoke()
        jshapes = jax.eval_shape(lambda k: jtransformer.init_params(cfg, k),
                                 jax.random.PRNGKey(0))
        meta = transformer.init_params(get_config(arch).smoke(),
                                       torch.Generator(), device="meta")
        got = [(n, tuple(t.shape), str(t.dtype).split(".")[-1])
               for n, t in tree_flatten_with_names(meta)]
        want = [(n, tuple(t.shape), t.dtype.name)
                for n, t in jckpt._flatten_with_names(jshapes)]
        assert got == want, arch
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget_config(arch))
