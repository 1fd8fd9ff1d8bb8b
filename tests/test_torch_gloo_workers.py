"""The gloo ranks of ``tests/test_torch_sharding.py``, in a file of their
own that imports neither ``jax`` nor anything of ``repro``, so that they
also run where the port runs alone (``chip_smoke.py``'s gloo phase runs
them on the card machine's CPU under its PyTorch).  It defines no test.

Run as a script, ``python tests/test_torch_gloo_workers.py OUT_DIR``
(with ``PYTHONPATH=src``), it spawns three sets of CPU ranks, one after
another, each writing one JSON file into ``OUT_DIR``:

* ``result.json``, 3 ranks on a (1, 3) mesh: for each of ``GLOO_ARCHS``
  (smoke configs in f32) the relative error of a prefill and 4 decode
  steps against the unsharded port (``serve_rel``), whether
  ``_pad_heads`` padded (smoke H = 4 on a 3-wide model axis), the loss
  and parameters of one train step with ``mesh=`` against the unsharded
  step, and the bytes of every all-gather of that step (``train_gathers``)
  beside the bytes of the attention weights, padded and unpadded
  (``weight_bytes``);
* ``grads.json``, 4 ranks on a (2, 2) mesh: for each of ``GRAD_ARCHS``
  and ``EXCHANGE_CASE`` the loss and the worst gradient leaf of
  ``loss_and_grads`` against the unsharded port, and the all-gathers and
  all-to-alls of that call, beside the bytes of one layer's
  in-projection where the arch has one (``w_in_bytes``); for the first
  arch, the fsdp MoE arch and ``EXCHANGE_CASE`` also one train step in
  microbatches of 2 rows (one row of each data rank's shard a
  microbatch) against the unsharded step (``train``), for the last two
  a prefill and 4 decode steps (``serve_rel``), and for each case the
  F slices of every exchange of fsdp expert weights it made
  (``experts_exchanged``) and the ways its embedding lookups took
  (``lookups``), with, for ``EXCHANGE_CASE``, the bytes of one layer's
  query projection; and under ``"lookup"``, the smoke ``FSDP_ARCH``'s
  embedding lookup under a split batch with the table gathered, kept
  split (each way forced) and by the rule's choice (``_lookup_ways``);
* ``seq.json``, the same 4 ranks: the smoke gemma3-1b decoding with its
  cache's sequence split (batch 2 and 1), and the smoke gemma2-27b (an
  FSDP arch) decoding at batch 1 (``fsdp_1``) and 2 (``fsdp_2``, one row
  a data rank: its weights and embedding table stay split and the rows
  move): relative errors of the decode steps, the cache's split, one
  decode step's collectives, and for ``fsdp_2`` the ways of the
  embedding lookups of its prefill and decode steps.

Each worker records what it measured and raises only on an error of the
sharded path itself; the limits are the caller's (``SHARD_RTOL`` and the
rules in ``tests/test_torch_sharding.py`` and ``chip_smoke.py``)."""

import json
import sys
from pathlib import Path

import torch

#: the gloo tests' relative limit against the unsharded port (f32)
SHARD_RTOL = 1e-5
GLOO_ARCHS = ("gemma3-1b", "granite-moe-3b-a800m")
#: the fsdp MoE arch, also served and trained on the (2, 2) ranks
MOE_FSDP_ARCH = "qwen3-moe-235b-a22b"
#: every block family: attention, MoE (with and without fsdp), the Mamba
#: SSM, the RG-LRU hybrid
GRAD_ARCHS = GLOO_ARCHS + ("falcon-mamba-7b", "recurrentgemma-9b",
                           MOE_FSDP_ARCH)
#: ``MOE_FSDP_ARCH`` with F below D, so that its fsdp expert weights split
#: along D, and 2 experts, one a model rank, each one's F over both data
#: ranks; with a wider D and a batch of one row of 8 tokens a data rank
#: (``EXCHANGE_SIZES``), ``sharding.gather_or_exchange`` keeps every fsdp
#: weight split and moves the rows (the ways it takes at full width at
#: decode and, for qwen3-moe's experts, in training)
EXCHANGE_CASE = MOE_FSDP_ARCH + "/exchange"
#: ``EXCHANGE_CASE``'s smoke sizes and its (B, S) batch
EXCHANGE_SIZES = {"d_model": 128, "d_ff": 64, "n_experts": 2}
EXCHANGE_BATCH = (2, 8)
#: the FSDP arch whose batch-1 decode keeps its weights split
FSDP_ARCH = "gemma2-27b"
OUT_FILES = {"result": "result.json", "2x2": "grads.json", "seq": "seq.json"}


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _gathers(mode):
    """Bytes of each all-gather that ``mode`` (a ``CostMode``) saw."""
    return [n for kind, n in mode.collectives if kind == "all-gather"]


def _serve(cfg, params, dparams, mesh, B=2, S=12, steps=4):
    """A prefill of B x S tokens and ``steps`` greedy decode steps,
    unsharded and then with the sharded parameters and batch under the
    activation mesh (each step fed the unsharded run's token): (relative
    errors of the sharded logits, prefill's first, the sharded cache)."""
    from repro_torch.models.lm import sharding, transformer
    toks = torch.randint(0, cfg.vocab, (B, S),
                         generator=torch.Generator().manual_seed(1))
    logits, cache = transformer.prefill(cfg, params, toks, S + steps)
    want, feed = [logits], []
    for _ in range(steps):
        tok = torch.argmax(logits[:, -1:], dim=-1)
        feed.append(tok)
        logits, cache = transformer.decode(cfg, params, tok, cache)
        want.append(logits)
    bs = sharding.batch_shardings(mesh, {"tokens": toks})
    with sharding.activation_mesh(mesh):
        dtoks = sharding.distribute({"tokens": toks}, bs)["tokens"]
        logits, dcache = transformer.prefill(cfg, dparams, dtoks, S + steps)
        got = [logits.full_tensor()]
        for tok in feed:
            dtok = sharding.distribute({"tokens": tok}, bs)["tokens"]
            logits, dcache = transformer.decode(cfg, dparams, dtok, dcache)
            got.append(logits.full_tensor())
    return [_rel(g, w) for g, w in zip(got, want)], dcache


def _train_step(cfg, params, dparams, mesh, batch):
    """One AdamW train step in microbatches of 2 rows, unsharded and with
    the sharded parameters, optimizer state and batch (``mesh=``; on 2
    data ranks one row of each rank's batch shard a microbatch): the
    relative errors of the loss and of the worst parameter, and the
    sharded step's all-gathers."""
    from repro_torch.launch.dryrun import CostMode
    from repro_torch.models.lm import model, sharding
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves
    opt = adamw.init(params)
    p1, _, m1 = model.make_train_step(cfg, microbatch=2)(params, opt, batch)
    dopt = sharding.distribute(opt, sharding.opt_shardings(cfg, mesh, opt,
                                                           params))
    dbatch = sharding.distribute(batch, sharding.batch_shardings(mesh, batch))
    mode = CostMode()
    with sharding.activation_mesh(mesh), mode:
        p2, _, m2 = model.make_train_step(cfg, microbatch=2, mesh=mesh)(
            dparams, dopt, dbatch)
    return {"loss_rel": abs(float(m2["loss"].full_tensor())
                            - float(m1["loss"])) / abs(float(m1["loss"])),
            "param_rel": max(_rel(a.full_tensor(), b) for a, b in zip(
                tree_leaves(p2), tree_leaves(p1))),
            "gathers": _gathers(mode)}


def _worker(rank, world, store_path, out_path):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import attention, sharding, transformer
    from repro_torch.tree import tree_flatten_with_names, tree_leaves, tree_map

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    mesh = make_host_mesh(device="cpu")
    padded = []
    real_pad = attention._pad_heads

    def spy(q, k, v):
        out = real_pad(q, k, v)
        if sharding._ACT_MESH.get() is not None:   # the sharded steps
            padded.append(out[0].shape[1] > out[3])    # (D, H_pad, hd)
        return out

    attention._pad_heads = spy
    results = {}
    for arch in GLOO_ARCHS:
        cfg = get_config(arch).smoke()
        params = tree_map(lambda t: t.float(), transformer.init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu"))
        ps = sharding.param_shardings(cfg, mesh, params)
        dparams = sharding.distribute(params, ps)
        padded.clear()
        serve_rel, dcache = _serve(cfg, params, dparams, mesh)
        cache_placed = all(isinstance(t, DTensor)
                           for t in tree_leaves(dcache.entries))
        serve_padded = bool(padded) and all(padded)

        batch = {"tokens": torch.randint(
            0, cfg.vocab, (4, 16), generator=torch.Generator().manual_seed(3))}
        batch["labels"] = batch["tokens"]
        train = _train_step(cfg, params, dparams, mesh, batch)
        m = sharding.mesh_axes(mesh)["model"]
        h_pad = cfg.n_heads + (-cfg.n_heads) % m
        # one layer's projection weights, f32
        weights = {name: t[0].numel() * 4 for name, t in
                   tree_flatten_with_names(params)
                   if name.split("/")[-1] in ("wq", "wk", "wv", "wo")}
        # each projection weight padded (or expanded) to H_pad heads
        weights.update({f"{name}@{h_pad}": n // t * h_pad for name, n, t in
                        ((k, v, cfg.n_heads if k.endswith(("wq", "wo"))
                          else cfg.n_kv_heads) for k, v in weights.items())})
        results[arch] = {
            "padded": serve_padded,
            "serve_rel": serve_rel,
            "loss_rel": train["loss_rel"], "param_rel": train["param_rel"],
            "cache_placed": cache_placed,
            "train_gathers": train["gathers"],
            "weight_bytes": weights,
        }
    if rank == 0:
        Path(out_path).write_text(json.dumps(results))
    dist.destroy_process_group()


def _grad_worker(rank, world, store_path, out_path):
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import CostMode
    from repro_torch.models.lm import model, moe, sharding, transformer
    from repro_torch.tree import tree_flatten_with_names, tree_leaves, tree_map

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    exchange_experts = moe._exchange_experts
    exchanged = []

    def spy(*args):
        exchanged.append(args[-1])                 # s, F's slices an expert
        return exchange_experts(*args)

    moe._exchange_experts = spy
    results = {}
    cases = [(arch, get_config(arch).smoke(), (4, 16)) for arch in GRAD_ARCHS]
    cases.append((EXCHANGE_CASE, dataclasses.replace(
        get_config(MOE_FSDP_ARCH).smoke(), **EXCHANGE_SIZES), EXCHANGE_BATCH))
    for arch, cfg, shape in cases:
        exchanged.clear()
        params = tree_map(lambda t: t.float(), transformer.init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu"))
        gen = torch.Generator().manual_seed(3)
        batch = {"tokens": torch.randint(0, cfg.vocab, shape, generator=gen),
                 "labels": torch.randint(0, cfg.vocab, shape, generator=gen)}
        loss, grads = model.loss_and_grads(cfg, params, batch)
        dparams = sharding.distribute(params, sharding.param_shardings(
            cfg, mesh, params))
        dbatch = sharding.distribute(batch, sharding.batch_shardings(mesh,
                                                                     batch))
        mode = CostMode()
        with sharding.activation_mesh(mesh), mode, \
                sharding.recording_lookups() as lookups:
            dloss, dgrads = model.loss_and_grads(cfg, dparams, dbatch)
        rel = [(_rel(a.full_tensor(), b), name) for (name, a), b in zip(
            tree_flatten_with_names(dgrads), tree_leaves(grads))]
        w_in = [t for name, t in tree_flatten_with_names(params)
                if name.endswith("ssm/w_in")]
        results[arch] = {
            "loss_rel": abs(float(dloss.full_tensor()) - float(loss))
            / abs(float(loss)),
            "grad_rel": max(rel)[0], "worst_leaf": max(rel)[1],
            "gathers": _gathers(mode),
            "all_to_alls": sum(1 for kind, _ in mode.collectives
                               if kind == "all-to-all"),
            "lookups": dict(lookups),
            # one layer's (D, 2 Di) in-projection, f32
            "w_in_bytes": w_in[0][0].numel() * 4 if w_in else None}
        if arch in (GRAD_ARCHS[0], MOE_FSDP_ARCH, EXCHANGE_CASE):
            # microbatches of 2 rows over the 2 data ranks: one row of
            # each rank's batch shard a microbatch
            results[arch]["train"] = _train_step(cfg, params, dparams, mesh,
                                                 batch)
        if arch in (MOE_FSDP_ARCH, EXCHANGE_CASE):
            results[arch]["serve_rel"], _ = _serve(cfg, params, dparams, mesh)
        if arch == EXCHANGE_CASE:
            # one layer's query projection (D, H, hd), f32
            results[arch]["wq_layer_bytes"] = (cfg.d_model * cfg.n_heads
                                               * cfg.hd * 4)
        results[arch]["experts_exchanged"] = sorted(set(exchanged))
    moe._exchange_experts = exchange_experts
    results["lookup"] = _lookup_ways(mesh)
    if rank == 0:
        Path(out_path).write_text(json.dumps(results))
    dist.destroy_process_group()


def _lookup_ways(mesh):
    """The smoke ``FSDP_ARCH``'s embedding table (its vocabulary over
    ``model``, D over ``data``) looked up by a (4, 16) batch of ids split
    over ``data``, through ``sharding.lookup_rows`` with
    ``gather_or_exchange`` forced to each way and left to its own choice
    (``"rule"``), against the unsharded lookup: for each, the relative
    errors of the rows and of the table's gradient (of the rows' dot
    product with fixed random weights), the ways the lookup recorded, the
    bytes of its all-gathers, and those of the table's local shard."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import CostMode
    from repro_torch.models.lm import sharding, transformer
    cfg = get_config(FSDP_ARCH).smoke()
    table = transformer.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")["embed"].float()
    gen = torch.Generator().manual_seed(5)
    idx = torch.randint(0, cfg.vocab, (4, 16), generator=gen)
    weight = torch.randn(4, 16, cfg.d_model, generator=gen)
    want = table.clone().requires_grad_()
    rows = want[idx]
    (rows * weight).sum().backward()
    spec = sharding.param_shardings(cfg, mesh, {"embed": table})
    didx = sharding.distribute({"tokens": idx}, sharding.batch_shardings(
        mesh, {"tokens": idx}))["tokens"]
    rule = sharding.gather_or_exchange
    out = {}
    for way in ("gather", "exchange", "rule"):
        dtable = sharding.distribute({"embed": table}, spec)["embed"]
        dtable.requires_grad_()
        if way != "rule":
            sharding.gather_or_exchange = lambda g, e, way=way: way
        mode = CostMode()
        try:
            with mode, sharding.recording_lookups() as lookups:
                drows = sharding.lookup_rows(dtable, didx).full_tensor()
                (drows * weight).sum().backward()
        finally:
            sharding.gather_or_exchange = rule
        out[way] = {"rows_rel": _rel(drows.detach(), rows.detach()),
                    "grad_rel": _rel(dtable.grad.full_tensor(), want.grad),
                    "grad_split": dtable.grad.placements == dtable.placements,
                    "lookups": dict(lookups), "gathers": _gathers(mode),
                    "table_shard_bytes": dtable.to_local().numel() * 4}
    return out


def _decode_run(cfg, params, dparams, mesh, B, S, steps):
    """Prefill S tokens and decode ``steps`` greedy tokens unsharded, then
    the same with the sharded parameters and batch under the activation
    mesh (each step fed the unsharded run's token); the first sharded
    decode step runs under ``CostMode``.  Returns (relative errors of the
    decode steps, the sharded cache, the ``CostMode``)."""
    from repro_torch.launch.dryrun import CostMode
    from repro_torch.models.lm import sharding, transformer
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
        prefilled = dcache
        got, mode = [], CostMode()
        for i, tok in enumerate(feed):
            dtok = sharding.distribute({"tokens": tok}, bs)["tokens"]
            if i == 0:
                with mode:
                    logits, dcache = transformer.decode(cfg, dparams, dtok,
                                                        dcache)
            else:
                logits, dcache = transformer.decode(cfg, dparams, dtok, dcache)
            got.append(logits.full_tensor())
    return [_rel(g, w) for g, w in zip(got, want)], prefilled, mode


def _seq_worker(rank, world, store_path, out_path):
    """Decode with the cache's sequence split, and the FSDP arch's batch-1
    decode (see the module docstring)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.models.lm import sharding, transformer
    from repro_torch.tree import tree_map

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))

    def placed(cfg):
        params = tree_map(lambda t: t.float(), transformer.init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu"))
        return params, sharding.distribute(params, sharding.param_shardings(
            cfg, mesh, params))

    cfg = get_config("gemma3-1b").smoke()
    assert cfg.n_kv_heads % 2 != 0
    params, dparams = placed(cfg)
    results, S, steps = {}, 12, 4
    for B, want_split in ((2, ["model"]), (1, ["data", "model"])):
        rel, dcache, mode = _decode_run(cfg, params, dparams, mesh, B, S,
                                        steps)
        k = dcache.entries[0].k
        split = [mesh.mesh_dim_names[i] for i, pl in enumerate(
            k.placements) if getattr(pl, "dim", None) == 2]
        results[str(B)] = {
            "want_split": want_split, "cache_seq_split": split,
            "decode_rel": rel,
            "max_reduces": sum(1 for kind, _ in mode.collectives
                               if kind == "all-reduce"),
            "gathered": sum(_gathers(mode)),
            "cache_layer_bytes": B * (S + steps) * cfg.n_kv_heads
            * cfg.hd * 4}
    cfg = get_config(FSDP_ARCH).smoke()
    assert cfg.fsdp
    params, dparams = placed(cfg)
    wq = dparams["segments"][0]["attn"].wq
    rel, _, mode = _decode_run(cfg, params, dparams, mesh, 1, S, steps)
    results["fsdp_1"] = {
        "wq_d_split": sharding.splits_dim(wq, 1),
        "decode_rel": rel, "gathered": sum(_gathers(mode)),
        # one layer's query projection (D, H, hd), f32
        "wq_layer_bytes": cfg.d_model * cfg.n_heads * cfg.hd * 4}
    # batch 2, one row a data rank: the fsdp products and the embedding
    # lookup keep their weights split and move the rows
    # (``sharding.gather_or_exchange``)
    with sharding.recording_lookups() as lookups:
        rel, _, mode = _decode_run(cfg, params, dparams, mesh, 2, S, steps)
    results["fsdp_2"] = {
        "decode_rel": rel, "gathers": _gathers(mode),
        "all_to_alls": sum(1 for kind, _ in mode.collectives
                           if kind == "all-to-all"),
        "lookups": dict(lookups),
        "wq_layer_bytes": cfg.d_model * cfg.n_heads * cfg.hd * 4}
    if rank == 0:
        Path(out_path).write_text(json.dumps(results))
    dist.destroy_process_group()


def run_all(out_dir) -> None:
    """Spawn the three sets of ranks, each writing its file into
    ``out_dir``."""
    import torch.multiprocessing as mp
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for fn, world, key in ((_worker, 3, "result"), (_grad_worker, 4, "2x2"),
                           (_seq_worker, 4, "seq")):
        mp.spawn(fn, args=(world, str(out_dir / f"store_{key}"),
                           str(out_dir / OUT_FILES[key])), nprocs=world)


def load(out_dir) -> dict:
    """The three files of ``run_all``, as the tests read them:
    ``result.json``'s archs at the top, ``"2x2"`` and ``"seq"`` beside."""
    out_dir = Path(out_dir)
    out = json.loads((out_dir / OUT_FILES["result"]).read_text())
    out["2x2"] = json.loads((out_dir / OUT_FILES["2x2"]).read_text())
    out["seq"] = json.loads((out_dir / OUT_FILES["seq"]).read_text())
    return out


if __name__ == "__main__":
    run_all(sys.argv[1])
