"""The port's sharding rules and sharded steps against the JAX package:

* rule parity: for all 10 archs, on duck-typed 16x16 and 2x16x16 meshes,
  with FSDP off and on, every ``param_pspec`` equals the reference's entry
  by entry; every ``batch_pspec`` and ``cache_pspec`` of each supported
  (arch, shape) equals the reference's;
* the abstract trees (``abstract_params``, ``abstract_opt_state``,
  ``init_cache_spec``) match the reference's ``eval_shape`` trees in shape
  and dtype;
* real collectives: 3 gloo ranks on a (1, 3) CPU mesh run the smoke
  gemma3-1b and granite-moe in f32 with the parameters, batch and cache
  placed by the rules, under ``activation_mesh``: prefill and 4 decode
  steps within 1e-5 of max |logit| of the unsharded port, and one train
  step with ``mesh=`` within 1e-5 of the unsharded step.  Smoke H = 4
  does not divide 3, so ``_pad_heads`` pads (the worker checks it did);
* data-parallel gradients: 4 gloo ranks on a (2, 2) mesh, where the
  batch, the heads, the FFN, the experts, the SSM/RG-LRU channels and
  the vocabulary split, give every gradient leaf of ``loss_and_grads``
  of the four block families (gemma3-1b, granite-moe, falcon-mamba,
  recurrentgemma) and of the fsdp MoE arch (qwen3-moe) within 1e-5 of
  its max |g| of the unsharded port (AdamW's normalised step would hide
  a gradient summed over too few ranks, so the gradients are compared,
  not the parameters); the fsdp MoE arch also serves and takes a train
  step there, by the rule's ways and with every fsdp weight kept split
  (its experts exchanged over the data ranks, F cut in 2, the embedding
  lookup's rows exchanged), within 1e-5;
* the embedding lookup of an ``fsdp`` table under a data-split batch on
  the same 4 ranks, gathering the table and exchanging the rows (each
  way forced, and by the rule's choice): rows and the table's gradient
  within 1e-5 of the unsharded lookup;
* no weight gathered where the reference's GSPMD keeps it split: the
  padded-head archs' train step on the 3 ranks gathers no projection
  weight or gradient; falcon-mamba's training on the (2, 2) mesh gathers
  no in-projection; the smoke FSDP arch decodes at batch 1 with its
  weights split along D, and at batch 2 (one row a data rank) moving the
  rows instead of its weights and its embedding table, within 1e-5 of
  the unsharded logits;
* sequence-reduced decode: on the same 4 ranks, the smoke gemma3-1b (1
  KV head, which does not divide ``model``) prefills and decodes with
  the cache's sequence split over ``model`` (batch 2) and over data x
  model (batch 1): 4 decode steps within 1e-5 of max |logit| of the
  unsharded port, the cache split as the rule says, and ``CostMode``
  sees the softmax reduced across shards and no all-gather as large as
  one layer's cache;
* off the card, a prefill from ``CHUNK_THRESHOLD`` tokens takes the
  q-chunked plain route, within 1e-6 of max |out| of the unchunked plain
  route in f32 at 8,192 tokens.

The gloo ranks run in a subprocess (``test_torch_gloo_workers.py`` run as
a script, which imports no jax, so ``chip_smoke.py`` runs the same ranks
on the card machine), so no process group is ever opened in a test
worker."""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_gloo_workers import (EXCHANGE_CASE, GLOO_ARCHS, GRAD_ARCHS,
                                     MOE_FSDP_ARCH, SHARD_RTOL, _rel, load)

ROOT = Path(__file__).resolve().parents[1]
WORKERS = ROOT / "tests" / "test_torch_gloo_workers.py"


class Mesh16:
    shape = {"data": 16, "model": 16}


class Mesh2x16:
    shape = {"pod": 2, "data": 16, "model": 16}


MESHES = {"16x16": Mesh16, "2x16x16": Mesh2x16}


def _archs():
    from repro_torch.configs import all_archs
    return all_archs()


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    from repro.configs import get_config as jget
    from repro.models.lm import model as jmodel
    return jmodel.abstract_params(jget(arch))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    from repro_torch.configs import get_config
    from repro_torch.models.lm import model
    return model.abstract_params(get_config(arch))


def _spec_entries(spec):
    return [tuple(e) if isinstance(e, (list, tuple)) else e for e in spec]


def _ref_flat(tree):
    from repro.models.lm import sharding as jsharding
    return [(jsharding._path_names(p), leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_flat(tree):
    from repro_torch.tree import tree_flatten_with_names
    return [(name.split("/"), leaf)
            for name, leaf in tree_flatten_with_names(tree)]


def _jdtype(dt):
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", _archs())
def test_param_pspec_equals_reference(arch, mesh, fsdp):
    from repro.configs import get_config as jget
    from repro.models.lm import sharding as jsharding
    from repro_torch.configs import get_config
    from repro_torch.models.lm import sharding
    jcfg = dataclasses.replace(jget(arch), fsdp=fsdp)
    cfg = dataclasses.replace(get_config(arch), fsdp=fsdp)
    m = MESHES[mesh]
    ref = _ref_flat(_ref_params(arch))
    port = _port_flat(_port_params(arch))
    assert [n for n, _ in port] == [n for n, _ in ref]
    for (names, leaf), (_, jleaf) in zip(port, ref):
        want = jsharding.param_pspec(jcfg, m, tuple(names), jleaf)
        got = sharding.param_pspec(cfg, m, tuple(names), leaf)
        assert _spec_entries(got) == _spec_entries(want), (names, got, want)


def _supported(arch):
    from repro_torch.configs import SHAPES, get_config, shape_supported
    return [s for s in SHAPES if shape_supported(get_config(arch),
                                                 SHAPES[s])[0]]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", _archs())
def test_batch_and_cache_pspecs_equal_reference(arch, mesh):
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget
    from repro.models.lm import model as jmodel
    from repro.models.lm import sharding as jsharding
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import _meta
    from repro_torch.models.lm import model, sharding
    m = MESHES[mesh]
    for shape_name in _supported(arch):
        jspec = jmodel.make_batch_spec(jget(arch), JSHAPES[shape_name])
        spec = model.make_batch_spec(get_config(arch), SHAPES[shape_name])
        assert sorted(spec) == sorted(jspec)
        for k in spec:
            assert _spec_entries(sharding.batch_pspec(m, spec[k].shape)) == \
                _spec_entries(jsharding.batch_pspec(m, jspec[k].shape)), k
        if SHAPES[shape_name].mode != "decode":
            continue
        jcache = jmodel.init_cache_spec(jget(arch), JSHAPES[shape_name])
        cache = _meta(model.init_cache_spec(get_config(arch),
                                            SHAPES[shape_name]))
        ref, port = _ref_flat(jcache), _port_flat(cache)
        assert [n for n, _ in port] == [n for n, _ in ref]
        for (names, leaf), (_, jleaf) in zip(port, ref):
            want = jsharding.cache_pspec(m, names, jleaf)
            got = sharding.cache_pspec(m, names, leaf)
            assert _spec_entries(got) == _spec_entries(want), (shape_name,
                                                               names)


@pytest.mark.parametrize("arch", _archs())
def test_abstract_trees_match_reference(arch):
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget
    from repro.models.lm import model as jmodel
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import _meta
    from repro_torch.models.lm import model
    cfg, jcfg = get_config(arch), jget(arch)

    def same(port, ref):
        p, r = _port_flat(port), _ref_flat(ref)
        assert [n for n, _ in p] == [n for n, _ in r]
        for (names, a), (_, b) in zip(p, r):
            assert tuple(a.shape) == tuple(b.shape), names
            assert _jdtype(a.dtype) == str(b.dtype), names

    same(_port_params(arch), _ref_params(arch))
    same(model.abstract_opt_state(cfg), jmodel.abstract_opt_state(jcfg))
    for shape_name in _supported(arch):
        if SHAPES[shape_name].mode == "decode":
            same(_meta(model.init_cache_spec(cfg, SHAPES[shape_name])),
                 jmodel.init_cache_spec(jcfg, JSHAPES[shape_name]))


def test_named_sharding_placements():
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.models.lm.sharding import P, NamedSharding
    assert NamedSharding(Mesh2x16, P(("pod", "data"), None, "model")
                         ).placements == (Shard(0), Shard(0), Shard(2))
    assert NamedSharding(Mesh16, P()).placements == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        NamedSharding(Mesh2x16, P(("data", "pod"))).placements


def test_hooks_are_noops_without_a_mesh():
    from repro_torch.models.lm import attention, sharding
    x, kv = torch.randn(2, 3, 4, 5), torch.randn(2, 3, 2, 5)
    assert sharding.constrain_tokens(x) is x
    assert sharding.constrain_cache(x) is x
    assert sharding.replicate_like(x, x) is x
    wq, wkv = torch.randn(5, 4, 3), torch.randn(5, 2, 3)   # (D, heads, hd)
    q, k, v, h = attention._pad_heads(wq, wkv, wkv)
    assert q is wq and k is wkv and v is wkv and h == 4


def test_write_slot_plain_is_a_slice_assignment():
    from repro_torch.models.lm import sharding
    a = torch.zeros(2, 5, 3)
    b = a.clone()
    new = torch.randn(2, 1, 3)
    sharding.write_slot(a, new, 1, torch.tensor(3))
    b[:, 3:4] = new
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# real collectives: 3 gloo ranks on a (1, 3) mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(WORKERS), str(tmp)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return load(tmp)


@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_sharded_serving_steps_match_unsharded(gloo_results, arch):
    r = gloo_results[arch]
    assert r["padded"], "smoke H = 4 on a 3-wide model axis must pad"
    assert len(r["serve_rel"]) == 5            # prefill + 4 decode steps
    assert max(r["serve_rel"]) <= SHARD_RTOL, r["serve_rel"]


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_data_parallel_gradients_match_unsharded(gloo_results, arch):
    r = gloo_results["2x2"][arch]
    assert r["loss_rel"] <= SHARD_RTOL
    assert r["grad_rel"] <= SHARD_RTOL, r["worst_leaf"]


@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_sharded_train_step_matches_unsharded(gloo_results, arch):
    r = gloo_results[arch]
    assert r["loss_rel"] <= SHARD_RTOL
    assert r["param_rel"] <= SHARD_RTOL, r["param_rel"]
    assert r["cache_placed"]


def test_data_parallel_microbatches_match_unsharded(gloo_results):
    """Microbatches of a data-split batch take their rows from each rank's
    own shard: the step gathers nothing and equals the unsharded step."""
    r = gloo_results["2x2"][GRAD_ARCHS[0]]["train"]
    assert r["loss_rel"] <= SHARD_RTOL
    assert r["param_rel"] <= SHARD_RTOL, r["param_rel"]
    assert r["gathers"] == [], r["gathers"]


@pytest.mark.parametrize("batch", [2, 1])
def test_sequence_split_decode_matches_unsharded(gloo_results, batch):
    r = gloo_results["seq"][str(batch)]
    assert r["cache_seq_split"] == r["want_split"], r
    assert len(r["decode_rel"]) == 4
    assert max(r["decode_rel"]) <= SHARD_RTOL, r["decode_rel"]
    assert r["max_reduces"] > 0
    assert r["gathered"] < r["cache_layer_bytes"], r


@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_padded_heads_train_step_gathers_no_weight(gloo_results, arch):
    """Smoke H = 4 on the 3-wide model axis: each rank builds its own
    slice of the padded heads, so neither the train step's forward nor its
    backward gathers a projection weight or its gradient (splitting a
    whole padded weight would gather its gradient back)."""
    r = gloo_results[arch]
    assert r["padded"]
    smallest = min(r["weight_bytes"].values())
    assert max(r["train_gathers"], default=0.0) < smallest, r


def test_falcon_mamba_training_gathers_no_in_projection(gloo_results):
    """On the (2, 2) mesh the in-projection's halves are exchanged between
    ranks (the rank's 2 x 16 tokens move less than the weight): no
    all-gather as large as one layer's ``w_in``, and the gradients match
    as before."""
    r = gloo_results["2x2"]["falcon-mamba-7b"]
    assert max(r["gathers"], default=0.0) < r["w_in_bytes"], r
    assert r["grad_rel"] <= SHARD_RTOL, r["worst_leaf"]


def test_fsdp_batch1_decode_keeps_weights_split(gloo_results):
    """The smoke FSDP arch at batch 1 on the (2, 2) mesh: its projection
    weights stay split along D over data; each rank contracts its slice,
    so a decode step gathers less than one layer's query projection, and
    its logits match the unsharded port's."""
    r = gloo_results["seq"]["fsdp_1"]
    assert r["wq_d_split"]
    assert len(r["decode_rel"]) == 4
    assert max(r["decode_rel"]) <= SHARD_RTOL, r["decode_rel"]
    assert r["gathered"] < r["wq_layer_bytes"], r


@pytest.mark.parametrize("case", [MOE_FSDP_ARCH, EXCHANGE_CASE])
def test_fsdp_moe_serving_and_train_step_match_unsharded(gloo_results,
                                                         case):
    """The fsdp MoE arch on the (2, 2) mesh, by the rule's ways at the
    smoke sizes and at ``EXCHANGE_CASE``'s, where it keeps every fsdp
    weight split: a prefill and 4 decode steps, and one train step in
    microbatches, within ``SHARD_RTOL`` of the unsharded port."""
    r = gloo_results["2x2"][case]
    assert len(r["serve_rel"]) == 5
    assert max(r["serve_rel"]) <= SHARD_RTOL, r["serve_rel"]
    assert r["train"]["loss_rel"] <= SHARD_RTOL
    assert r["train"]["param_rel"] <= SHARD_RTOL, r["train"]


def test_exchanged_fsdp_experts_match_unsharded(gloo_results):
    """The experts' fsdp weights split along D, kept split by the rule at
    ``EXCHANGE_CASE``'s sizes: each of the 2 experts' F is cut over both
    data ranks (s = 2), the weights, slots and outputs move by
    all-to-alls, the gradients match, the embedding lookup exchanges its
    rows (``lookup_rows``), and nothing as large as one layer's query
    projection is gathered, so every fsdp weight stayed split."""
    r = gloo_results["2x2"][EXCHANGE_CASE]
    assert r["experts_exchanged"] == [2], r
    assert r["all_to_alls"] > 0
    assert r["lookups"] == {"exchange": 1}, r["lookups"]
    assert [n for n in r["gathers"] if n >= r["wq_layer_bytes"]] == [], r
    assert r["loss_rel"] <= SHARD_RTOL
    assert r["grad_rel"] <= SHARD_RTOL, r["worst_leaf"]


def test_fsdp_batch2_decode_moves_rows(gloo_results):
    """The smoke FSDP arch at batch 2 on the (2, 2) mesh (one row a data
    rank): the products and the embedding lookup (its prefill's and each
    decode step's) keep their weights split and move the rows
    (all-to-alls), gathering nothing as large as one layer's query
    projection, and the logits match the unsharded port's."""
    r = gloo_results["seq"]["fsdp_2"]
    assert len(r["decode_rel"]) == 4
    assert max(r["decode_rel"]) <= SHARD_RTOL, r["decode_rel"]
    assert r["all_to_alls"] > 0
    assert r["lookups"] == {"exchange": 5}, r["lookups"]
    assert [n for n in r["gathers"] if n >= r["wq_layer_bytes"]] == [], r


@pytest.mark.parametrize("way", ["gather", "exchange", "rule"])
def test_fsdp_lookup_matches_unsharded(gloo_results, way):
    """The smoke FSDP arch's embedding table (vocabulary over ``model``, D
    over ``data``) looked up by a batch split over ``data`` on the (2, 2)
    mesh, with ``gather_or_exchange`` forced to each way and left to its
    own choice (the exchange, at these sizes): the rows and the table's
    gradient within ``SHARD_RTOL`` of the unsharded lookup, the gradient
    split as the table is, and the exchange gathering only the ids,
    nothing as large as the table's shard on a rank."""
    r = gloo_results["2x2"]["lookup"][way]
    want = "exchange" if way == "rule" else way
    assert r["lookups"] == {want: 1}, r["lookups"]
    assert r["rows_rel"] <= SHARD_RTOL
    assert r["grad_rel"] <= SHARD_RTOL
    assert r["grad_split"]
    if want == "exchange":
        # the ids, then the test's own gather of the rows to compare them
        assert r["gathers"][0] < r["table_shard_bytes"], r["gathers"]
        assert len(r["gathers"]) == 2, r["gathers"]
    else:
        assert r["gathers"][0] == 2 * r["table_shard_bytes"], r["gathers"]


@pytest.mark.parametrize("window", [None, 512])
def test_chunked_cpu_prefill_equals_unchunked(monkeypatch, window):
    """``attention.forward`` on CPU tensors at ``CHUNK_THRESHOLD`` tokens
    (the q-chunked plain route) against the same call with the threshold
    out of reach (the unchunked plain version of the kernel); smoke width
    with 2 heads on 1 KV head, so the unchunked logits take 512 MiB."""
    from repro_torch.models.lm import attention
    S = attention.CHUNK_THRESHOLD
    gen = torch.Generator().manual_seed(0)
    p = attention.init(gen, 64, 2, 1, 16, dtype=torch.float32, device="cpu")
    x = torch.randn(1, S, 64, generator=gen)
    pos = torch.arange(S)
    got = attention.forward(p, x, pos, window=window)
    monkeypatch.setattr(attention, "CHUNK_THRESHOLD", 2 * S)
    want = attention.forward(p, x, pos, window=window)
    assert _rel(got, want) <= 1e-6


