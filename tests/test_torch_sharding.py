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
  recurrentgemma) within 1e-5 of its max |g| of the unsharded port
  (AdamW's normalised step would hide a gradient summed over too few
  ranks, so the gradients are compared, not the parameters);
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

The gloo ranks run in a subprocess (this file run as a script), so no
process group is ever opened in a test worker."""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]
SHARD_RTOL = 1e-5


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
    assert sharding.constrain_moe_slots(x) is x
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
    sharding.write_slot(a, new, 1, 3)
    b[:, 3:4] = new
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# real collectives: 3 gloo ranks on a (1, 3) mesh
# ---------------------------------------------------------------------------

GLOO_ARCHS = ("gemma3-1b", "granite-moe-3b-a800m")
#: every block family: attention, MoE, the Mamba SSM, the RG-LRU hybrid
GRAD_ARCHS = GLOO_ARCHS + ("falcon-mamba-7b", "recurrentgemma-9b")


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, __file__, str(tmp)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads((tmp / "result.json").read_text())
    out["2x2"] = json.loads((tmp / "grads.json").read_text())
    out["seq"] = json.loads((tmp / "seq.json").read_text())
    return out


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


@pytest.mark.parametrize("batch", [2, 1])
def test_sequence_split_decode_matches_unsharded(gloo_results, batch):
    r = gloo_results["seq"][str(batch)]
    assert r["cache_seq_split"] == r["want_split"], r
    assert len(r["decode_rel"]) == 4
    assert max(r["decode_rel"]) <= SHARD_RTOL, r["decode_rel"]
    assert r["max_reduces"] > 0
    assert r["gathered"] < r["cache_layer_bytes"], r


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


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _worker(rank, world, store_path, out_path):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import attention, model, sharding, transformer
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves, tree_map

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    mesh = make_host_mesh(device="cpu")
    padded = []
    real_pad = attention._pad_heads

    def spy(q, k, v):
        out = real_pad(q, k, v)
        padded.append(out[0].shape[1] > out[3])    # (D, H_pad, hd) weights
        return out

    attention._pad_heads = spy
    results = {}
    B, S, steps = 2, 12, 4
    for arch in GLOO_ARCHS:
        cfg = get_config(arch).smoke()
        params = tree_map(lambda t: t.float(), transformer.init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu"))
        toks = torch.randint(0, cfg.vocab, (B, S),
                             generator=torch.Generator().manual_seed(1))
        logits, cache = transformer.prefill(cfg, params, toks, S + steps)
        want, feed = [logits], []
        for _ in range(steps):
            tok = torch.argmax(logits[:, -1:], dim=-1)
            feed.append(tok)
            logits, cache = transformer.decode(cfg, params, tok, cache)
            want.append(logits)

        ps = sharding.param_shardings(cfg, mesh, params)
        dparams = sharding.distribute(params, ps)
        bs = sharding.batch_shardings(mesh, {"tokens": toks})
        padded.clear()
        with sharding.activation_mesh(mesh):
            dtoks = sharding.distribute({"tokens": toks}, bs)["tokens"]
            logits, dcache = transformer.prefill(cfg, dparams, dtoks, S + steps)
            got = [logits.full_tensor()]
            for tok in feed:
                dtok = sharding.distribute({"tokens": tok}, bs)["tokens"]
                logits, dcache = transformer.decode(cfg, dparams, dtok, dcache)
                got.append(logits.full_tensor())
        cache_placed = all(isinstance(t, DTensor)
                           for t in tree_leaves(dcache.entries))
        serve_padded = bool(padded) and all(padded)

        batch = {"tokens": torch.randint(
            0, cfg.vocab, (4, 16), generator=torch.Generator().manual_seed(3))}
        batch["labels"] = batch["tokens"]
        opt = adamw.init(params)
        p1, _, m1 = model.make_train_step(cfg, microbatch=2)(params, opt,
                                                             batch)
        dopt = sharding.distribute(opt, sharding.opt_shardings(cfg, mesh, opt,
                                                               params))
        dbatch = sharding.distribute(batch, sharding.batch_shardings(mesh,
                                                                     batch))
        with sharding.activation_mesh(mesh):
            p2, _, m2 = model.make_train_step(cfg, microbatch=2, mesh=mesh)(
                dparams, dopt, dbatch)
        results[arch] = {
            "padded": serve_padded,
            "serve_rel": [_rel(g, w) for g, w in zip(got, want)],
            "loss_rel": abs(float(m2["loss"].full_tensor()) - float(m1["loss"]))
            / abs(float(m1["loss"])),
            "param_rel": max(_rel(a.full_tensor(), b) for a, b in zip(
                tree_leaves(p2), tree_leaves(p1))),
            "cache_placed": cache_placed,
        }
    if rank == 0:
        Path(out_path).write_text(json.dumps(results))
    dist.destroy_process_group()


def _grad_worker(rank, world, store_path, out_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.models.lm import model, sharding, transformer
    from repro_torch.tree import tree_flatten_with_names, tree_leaves, tree_map

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    results = {}
    for arch in GRAD_ARCHS:
        cfg = get_config(arch).smoke()
        params = tree_map(lambda t: t.float(), transformer.init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu"))
        gen = torch.Generator().manual_seed(3)
        batch = {"tokens": torch.randint(0, cfg.vocab, (4, 16), generator=gen),
                 "labels": torch.randint(0, cfg.vocab, (4, 16), generator=gen)}
        loss, grads = model.loss_and_grads(cfg, params, batch)
        dparams = sharding.distribute(params, sharding.param_shardings(
            cfg, mesh, params))
        dbatch = sharding.distribute(batch, sharding.batch_shardings(mesh,
                                                                     batch))
        with sharding.activation_mesh(mesh):
            dloss, dgrads = model.loss_and_grads(cfg, dparams, dbatch)
        rel = [(_rel(a.full_tensor(), b), name) for (name, a), b in zip(
            tree_flatten_with_names(dgrads), tree_leaves(grads))]
        results[arch] = {
            "loss_rel": abs(float(dloss.full_tensor()) - float(loss))
            / abs(float(loss)),
            "grad_rel": max(rel)[0], "worst_leaf": max(rel)[1]}
    if rank == 0:
        Path(out_path).write_text(json.dumps(results))
    dist.destroy_process_group()


def _seq_worker(rank, world, store_path, out_path):
    """Decode with the cache's sequence split (see the module docstring)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import CostMode
    from repro_torch.models.lm import sharding, transformer
    from repro_torch.tree import tree_map

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = get_config("gemma3-1b").smoke()
    assert cfg.n_kv_heads % 2 != 0
    params = tree_map(lambda t: t.float(), transformer.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    dparams = sharding.distribute(params, sharding.param_shardings(
        cfg, mesh, params))
    results, S, steps = {}, 12, 4
    for B, want_split in ((2, ["model"]), (1, ["data", "model"])):
        toks = torch.randint(0, cfg.vocab, (B, S),
                             generator=torch.Generator().manual_seed(B))
        logits, cache = transformer.prefill(cfg, params, toks, S + steps)
        want, feed = [], []
        for _ in range(steps):
            tok = torch.argmax(logits[:, -1:], dim=-1)
            feed.append(tok)
            logits, cache = transformer.decode(cfg, params, tok, cache)
            want.append(logits)
        bs = sharding.batch_shardings(mesh, {"tokens": toks})
        with sharding.activation_mesh(mesh):
            dtoks = sharding.distribute({"tokens": toks}, bs)["tokens"]
            _, dcache = transformer.prefill(cfg, dparams, dtoks, S + steps)
            k = dcache.entries[0].k
            split = [mesh.mesh_dim_names[i] for i, pl in enumerate(
                k.placements) if getattr(pl, "dim", None) == 2]
            got, mode = [], None
            for i, tok in enumerate(feed):
                dtok = sharding.distribute({"tokens": tok}, bs)["tokens"]
                if i == 0:
                    mode = CostMode()
                    with mode:
                        logits, dcache = transformer.decode(cfg, dparams,
                                                            dtok, dcache)
                else:
                    logits, dcache = transformer.decode(cfg, dparams, dtok,
                                                        dcache)
                got.append(logits.full_tensor())
        results[str(B)] = {
            "want_split": want_split, "cache_seq_split": split,
            "decode_rel": [_rel(g, w) for g, w in zip(got, want)],
            "max_reduces": sum(1 for kind, _ in mode.collectives
                               if kind == "all-reduce"),
            "gathered": sum(n for kind, n in mode.collectives
                            if kind == "all-gather"),
            "cache_layer_bytes": B * (S + steps) * cfg.n_kv_heads
            * cfg.hd * 4}
    if rank == 0:
        Path(out_path).write_text(json.dumps(results))
    dist.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp
    out_dir = Path(sys.argv[1])
    mp.spawn(_worker, args=(3, str(out_dir / "store"),
                            str(out_dir / "result.json")), nprocs=3)
    mp.spawn(_grad_worker, args=(4, str(out_dir / "store4"),
                                 str(out_dir / "grads.json")), nprocs=4)
    mp.spawn(_seq_worker, args=(4, str(out_dir / "store_seq"),
                                str(out_dir / "seq.json")), nprocs=4)
