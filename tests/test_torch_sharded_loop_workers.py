"""The gloo ranks of ``tests/test_torch_sharded_loops.py``: the port's two
loops on sharded state, through their entry points (``Server`` and
``train(..., mesh=)``), and the graphed steps' logic on DTensors under
``tests/test_torch_prefill_graph.py``'s stand-ins for the CUDA graph
machinery.  It imports neither ``jax`` nor anything of ``repro`` and
defines no test.

Run as a script, ``python tests/test_torch_sharded_loop_workers.py DIR``
(with ``PYTHONPATH=src:tests``), after the test process has written into
``DIR/in/`` the served parameters (``serve/``, a checkpoint of the
reference's f32 parameters), the prompts (``prompts.json``) and the
reference loop's step-0 checkpoint (``step0/``).  It spawns one rank on a
(1, 1) mesh, then two ranks on a (1, 2) mesh; for each mesh rank 0
writes ``DIR/<mesh>.json``, and the ranks' checkpoints lie under
``DIR/<mesh>/``:

* ``serve``: the greedy tokens of ``Server`` on the sharded parameters,
  without and with a decode fault at step 1 (the retry's re-prefill);
* ``train``: the losses of ``train(..., mesh=)`` resumed from the
  reference's step-0 checkpoint (``train/``), and of the same run cut at
  step 2 and resumed (``resume/``); ``fresh/`` holds the step-0
  checkpoint of a sharded run from the port's own initialisation;
* ``graph``: what the stand-in graphs did with DTensor parameters (keys,
  placements of the static buffers, replays against the plain sharded
  steps, flash counts, errors, host reads), each as a boolean or a count.

Each rank raises only on an error of the sharded path itself; the limits
are the tests'."""

import contextlib
import dataclasses
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

MESHES = {1: {"1x1": (1, 1)}, 2: {"1x2": (1, 2)}}
SERVE_ARCH = "gemma3-1b"
#: the train loop's model and shape (``tests/test_torch_train_loop.py``'s)
TRAIN_ARCH = "stablelm-1.6b"
TRAIN_SHAPE = ("rt-train", 32, 8, "train")
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=100)
TRAIN_STEPS = 4
MAX_NEW = 6
FAULT_AT = 1
#: the archs whose sharded steps run under the host-read guards
HOST_READ_ARCHS = ("gemma3-1b", "granite-moe-3b-a800m")


def serve_cfg():
    """gemma3-1b's smoke config cut to two layers."""
    from repro_torch.configs import get_config
    cfg = get_config(SERVE_ARCH).smoke()
    return dataclasses.replace(cfg, segments=tuple(
        dataclasses.replace(s, n=n) for s, n in zip(cfg.segments, (2,))))


def train_loop_cfg(ckpt_dir, total):
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import TrainLoopConfig
    return TrainLoopConfig(total_steps=total, ckpt_every=2,
                           ckpt_dir=str(ckpt_dir), log_every=0,
                           opt=adamw.AdamWConfig(**OPT))


def _barrier():
    import torch.distributed as dist
    dist.barrier()


def dist_rank() -> int:
    import torch.distributed as dist
    return dist.get_rank()


def _fresh_copy(src, dst):
    """``src`` copied to ``dst`` by rank 0, the other ranks waiting."""
    if dist_rank() == 0:
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(src, dst)
    _barrier()


def fault_once(at):
    """A fault hook that raises once, at decode step ``at`` (never for
    None)."""
    fired = []

    def hook(step):
        if step == at and not fired:
            fired.append(step)
            raise RuntimeError("injected decode fault")
    return hook


def _serve(mesh, root, graphed=False):
    """``Server`` on the served parameters placed on ``mesh``, without and
    with a decode fault at ``FAULT_AT`` (keys ``retry_...``): the tokens,
    prefills and retries of each.  With ``graphed``, both steps are
    ``GraphedPrefill`` and ``GraphedDecode`` under the stand-ins (which the
    caller installs), and the graphs each made are kept too."""
    import test_torch_prefill_graph as tpg
    from repro_torch.checkpoint import ckpt
    from repro_torch.models.lm import sharding, transformer
    from repro_torch.runtime.serve_loop import (GraphedDecode,
                                                GraphedPrefill, Request,
                                                Server)
    cfg = serve_cfg()
    like = transformer.init_params(cfg, torch.Generator(), device="meta")
    params, _ = ckpt.restore(str(root / "in" / "serve"), 0, like, "cpu")
    dparams = sharding.distribute(params, sharding.param_shardings(
        cfg, mesh, params))
    prompts = json.loads((root / "in" / "prompts.json").read_text())
    out = {}
    for key, at in (("", None), ("retry_", FAULT_AT)):
        server = Server(cfg, dparams, max_batch=2, s_max=32,
                        fault_hook=fault_once(at))
        if graphed:
            pre = GraphedPrefill(cfg, dparams, s_max=32)
            tpg._replaying(pre, tpg._counting(pre, per_step=0))
            dec = GraphedDecode(cfg, dparams)
            _decode_replaying(dec)
            server.prefill_graph = server.prefill = pre
            server.graph = server.decode = dec
        reqs = [Request(i, torch.tensor(p), max_new=MAX_NEW)
                for i, p in enumerate(prompts)]
        stats = server.serve(reqs)
        out.update({key + "tokens": [r.out_tokens for r in reqs],
                    key + "prefills": stats.prefills,
                    key + "retries": stats.retries})
        if graphed:
            out[key + "graphs"] = [len(pre.graphs), len(dec.graphs)]
    return out


def _train(mesh, root, out):
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.runtime.train_loop import train
    cfg = get_config(TRAIN_ARCH).smoke()
    shape = ShapeSpec(*TRAIN_SHAPE)
    _fresh_copy(root / "in" / "step0", out / "train")
    full = train(cfg, shape, train_loop_cfg(out / "train", TRAIN_STEPS),
                 mesh=mesh, device="cpu")
    _fresh_copy(root / "in" / "step0", out / "resume")
    first = train(cfg, shape, train_loop_cfg(out / "resume", 2), mesh=mesh,
                  device="cpu")
    second = train(cfg, shape, train_loop_cfg(out / "resume", TRAIN_STEPS),
                   mesh=mesh, device="cpu")
    if dist_rank() == 0:
        shutil.rmtree(out / "fresh", ignore_errors=True)
    _barrier()
    train(cfg, shape, train_loop_cfg(out / "fresh", 0), mesh=mesh,
          device="cpu")
    return {"losses": full.losses, "resumed_from": full.resumed_from,
            "retries": full.retries, "rollbacks": full.rollbacks,
            "resume_losses": first.losses + second.losses,
            "resume_points": [first.resumed_from, second.resumed_from]}


# ---------------------------------------------------------------------------
# the graphed steps under the stand-ins, on DTensors
# ---------------------------------------------------------------------------

def _placed(cfg, mesh, seed=0):
    from repro_torch.models.lm import sharding, transformer
    from repro_torch.tree import tree_map
    params = tree_map(lambda t: t.float(), transformer.init_params(
        cfg, torch.Generator().manual_seed(seed), device="cpu"))
    return params, sharding.distribute(params, sharding.param_shardings(
        cfg, mesh, params))


def _tokens(cfg, mesh, width, batch=2, seed=0, placements=None):
    """A (batch, width) token batch placed by ``batch_shardings``, or by
    ``placements``."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.lm import sharding
    toks = torch.randint(0, cfg.vocab, (batch, width),
                         generator=torch.Generator().manual_seed(seed))
    if placements is None:
        return sharding.place_batch(mesh, {"tokens": toks})["tokens"]
    return distribute_tensor(toks, mesh, placements, src_data_rank=None)


def _all_equal(got, want) -> bool:
    from repro_torch.models.lm import sharding
    from repro_torch.tree import tree_leaves
    return all(sharding.placement_of(a) == sharding.placement_of(b)
               and torch.equal(sharding.local_tensor(a),
                               sharding.local_tensor(b))
               for a, b in zip(tree_leaves(got), tree_leaves(want),
                               strict=True))


def _placed_as(tree, like) -> bool:
    """Every leaf of ``tree`` placed as the leaf of ``like`` (a DTensor
    where that is one: all but a cache's position counter, which the
    step makes a plain tensor), and the first leaf a DTensor."""
    from repro_torch.models.lm import sharding
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(tree)
    return sharding.placement_of(leaves[0]) is not None and all(
        sharding.placement_of(a) == sharding.placement_of(b)
        for a, b in zip(leaves, tree_leaves(like), strict=True))


def _decode_replaying(graphed):
    """Each graph ``graphed`` (a ``GraphedDecode``) captures made to
    recompute at its replays: the plain step over the static token and
    cache, its logits copied into the static logits."""
    from repro_torch.runtime.serve_loop import _copy_into
    capture = graphed.capture

    def captured(params, token, cache):
        c = capture(params, token, cache)

        def rerun():
            logits, _ = graphed.step(params, c.token, c.cache)
            _copy_into(c.logits, logits)
        c.graph.rerun = rerun
        return c

    graphed.capture = captured


def _prefill_graph_checks(cfg, mesh, st):
    """``GraphedPrefill`` on DTensor parameters under the stand-ins."""
    from torch.distributed.tensor import Replicate, Shard
    import test_torch_prefill_graph as tpg
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.lm import sharding
    from repro_torch.runtime.serve_loop import GraphedPrefill, GraphError
    out = {}
    params, dparams = _placed(cfg, mesh)
    graphed = GraphedPrefill(cfg, dparams, s_max=24)
    plain = tpg._counting(graphed)
    tpg._replaying(graphed, plain)
    key = GraphedPrefill.key
    toks = _tokens(cfg, mesh, 9)
    other = [Shard(0) if pl == Replicate() else Replicate()
             for pl in toks.placements]
    moved = _tokens(cfg, mesh, 9, placements=other)
    out["key_same_for_clone"] = key({"tokens": toks}) == key(
        {"tokens": toks.clone()})
    out["key_separates_placements"] = key({"tokens": toks}) != key(
        {"tokens": moved})
    out["key_separates_whole"] = key({"tokens": toks}) != key(
        {"tokens": sharding.whole(toks)})
    # refused before anything runs, and before the pool is made
    refused = 0
    for fn in (graphed.capture, graphed):
        try:
            fn(params, {"tokens": toks})
        except ValueError:
            refused += 1
    out["other_params_refused"] = refused == 2 and not graphed.graphs \
        and graphed.pool is None
    with sharding.activation_mesh(mesh):
        want = plain(dparams, {"tokens": toks})
        got = graphed(dparams, {"tokens": toks})
        (c,) = graphed.graphs.values()
        out["static_inputs_placed"] = _placed_as(c.batch, {"tokens": toks})
        out["static_outputs_placed"] = _placed_as(c.out, want)
        out["capture_equal"] = _all_equal(got, want)
        launches = flash_attention.launches
        again = _tokens(cfg, mesh, 9, seed=1)
        got = graphed(dparams, {"tokens": again})
        out["replay_equal"] = _all_equal(got, plain(dparams,
                                                    {"tokens": again}))
        out["replays"] = st.replays
        out["launches_a_replay"] = flash_attention.launches - launches
        got = graphed(dparams, {"tokens": moved})
        out["graphs_after_two_placements"] = len(graphed.graphs)
        out["moved_equal"] = _all_equal(got, plain(dparams,
                                                   {"tokens": moved}))
        st.fail_replay = st.replays + 1
        try:
            graphed(dparams, {"tokens": toks})
            out["replay_error"] = "none"
        except GraphError:
            out["replay_error"] = "GraphError"
        st.fail_replay = None
    out["pools"] = len(set(st.pools))
    return out


def _decode_graph_checks(cfg, mesh, st):
    """``GraphedDecode`` on DTensor parameters under the stand-ins: its
    replays against the plain sharded decode steps."""
    from repro_torch.models.lm import model, sharding
    from repro_torch.runtime.serve_loop import GraphedDecode, GraphError
    from repro_torch.tree import tree_map
    out = {}
    _, dparams = _placed(cfg, mesh)
    prefill = model.make_prefill_step(cfg, s_max=20)
    decode = model.make_decode_step(cfg)
    graphed = GraphedDecode(cfg, dparams)
    _decode_replaying(graphed)
    with sharding.activation_mesh(mesh):
        logits, cache = prefill(dparams, {"tokens": _tokens(cfg, mesh, 9)})
        want_cache = tree_map(torch.clone, cache)
        equal, placed = True, True
        tok = torch.argmax(logits[:, -1:], dim=-1)
        for _ in range(4):
            got, got_cache = graphed(dparams, tok, cache)
            want, want_cache = decode(dparams, tok, want_cache)
            equal &= _all_equal((got, got_cache), (want, want_cache))
            placed &= _placed_as((got, got_cache), (want, want_cache))
            tok, cache = torch.argmax(want[:, -1:], dim=-1), got_cache
        out["replay_equal"] = equal
        out["static_placed"] = placed
        out["graphs"] = len(graphed.graphs)
        key = GraphedDecode.key
        out["key_separates_whole"] = key(tok, cache) != key(
            sharding.whole(tok), cache)
        st.fail_replay = st.replays + 1
        try:
            graphed(dparams, tok, cache)
            out["replay_error"] = "none"
        except GraphError:
            out["replay_error"] = "GraphError"
        st.fail_replay = None
    return out


def _train_graph_checks(mesh, root):
    """``train(..., mesh=)`` through ``tests/test_torch_train_graph.py``'s
    eager stand-in for the recording (``EagerGraphed``), its keys and
    refusals on sharded state."""
    import test_torch_train_graph as ttg
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models.lm import sharding, transformer
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop
    from repro_torch.tree import tree_map
    cfg = get_config(TRAIN_ARCH).smoke()
    out = {}
    made = []

    class Keeping(ttg.EagerGraphed):
        """Keeps its last capture (``train`` drops its graphs at the end)."""

        def capture(self, *args):
            self.kept = super().capture(*args)
            return self.kept

    def maker(cfg, tcfg, device, mesh=None):
        made.append(Keeping(cfg, tcfg, mesh))
        return made[-1]

    dst = root / f"graphed_{'x'.join(map(str, mesh.shape))}"
    _fresh_copy(root / "in" / "step0", dst)
    orig = train_loop.step_for_device
    train_loop.step_for_device = maker
    try:
        rep = train_loop.train(cfg, ShapeSpec(*TRAIN_SHAPE),
                               train_loop_cfg(dst, TRAIN_STEPS), mesh=mesh,
                               device="cpu")
    finally:
        train_loop.step_for_device = orig
    out["losses"] = rep.losses
    out["captures"] = len(rep.capture_seconds)
    g = made[0].kept
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    opt = adamw.init(params)
    dparams = sharding.distribute(params, sharding.param_shardings(
        cfg, mesh, params))
    dopt = sharding.distribute(opt, sharding.opt_shardings(cfg, mesh, opt,
                                                           params))
    out["static_placed"] = _placed_as((g.params, g.opt), (dparams, dopt))
    graphed = ttg.EagerGraphed(cfg, ttg.TCFG, mesh)
    batch = make_batch(cfg, ShapeSpec(*TRAIN_SHAPE), 0, device="cpu")
    dbatch = sharding.place_batch(mesh, batch)
    out["whole_state_refused"] = [
        _refused(graphed, p, o, b)
        for p, o, b in ((params, opt, batch), (dparams, opt, dbatch))]
    key = train_loop.GraphedTrainStep.key
    out["key_separates_whole"] = key(dparams, dopt, dbatch) != key(
        dparams, dopt, batch) and key(dparams, dopt, dbatch) == key(
        *tree_map(torch.clone, (dparams, dopt, dbatch)))
    out["sharded_state_refused_without_mesh"] = _refused(
        train_loop.GraphedTrainStep(cfg, ttg.TCFG), dparams, dopt, dbatch)
    return out


def _refused(graphed, params, opt_state, batch) -> bool:
    """Whether ``graphed.capture`` refuses the state for its shapes or
    placements (before anything runs)."""
    try:
        graphed.capture(params, opt_state, batch)
    except ValueError as e:
        return "other shapes or placements" in str(e)
    return False


@contextlib.contextmanager
def _no_host_reads(mp):
    """``tests/test_torch_prefill_graph.py``'s dispatch mode, and
    ``item``, ``tolist`` and the conversions to Python numbers and bools
    made to raise (``tests/test_torch_train_graph.py``'s guard): a value
    read on the host anywhere, DTensor's own code included, fails."""
    import test_torch_prefill_graph as tpg

    def host_read(*a, **k):
        raise AssertionError("a value was read on the host")

    with mp.context() as m:
        for name in ("item", "tolist", "__float__", "__int__", "__bool__"):
            m.setattr(torch.Tensor, name, host_read)
        with tpg._NoHostReads(m):
            yield


def _host_read_checks(mesh, mp):
    """The sharded prefill, decode and train steps under the host-read
    guards; each must run through (a host read raises)."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models.lm import model, sharding
    from repro_torch.optim import adamw
    out = {}
    for arch in HOST_READ_ARCHS:
        cfg = get_config(arch).smoke()
        params, dparams = _placed(cfg, mesh)
        prefill = model.make_prefill_step(cfg, s_max=14)
        decode = model.make_decode_step(cfg)
        step = model.make_train_step(cfg, mesh=mesh)
        opt = adamw.init(params)
        dopt = sharding.distribute(opt, sharding.opt_shardings(
            cfg, mesh, opt, params))
        batch = sharding.place_batch(mesh, make_batch(
            cfg, ShapeSpec("t", 8, 4, "train"), 0, device="cpu"))
        toks = _tokens(cfg, mesh, 9)
        done = []
        with sharding.activation_mesh(mesh):
            logits, cache = prefill(dparams, {"tokens": toks})
            tok = torch.argmax(logits[:, -1:], dim=-1)
            for name, fn in (
                    ("prefill", lambda: prefill(dparams, {"tokens": toks})),
                    ("decode", lambda: decode(dparams, tok, cache)),
                    ("train", lambda: step(dparams, dopt, batch))):
                with _no_host_reads(mp):
                    fn()
                done.append(name)
        out[arch] = done
    return out


def _graph_checks(mesh, root):
    import test_torch_prefill_graph as tpg
    cfg = serve_cfg()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        st = tpg.stand_ins.__wrapped__(mp)
        out["prefill"] = _prefill_graph_checks(cfg, mesh, st)
        out["decode"] = _decode_graph_checks(cfg, mesh, st)
        out["server"] = _serve(mesh, root, graphed=True)
    out["train"] = _train_graph_checks(mesh, root)
    with pytest.MonkeyPatch.context() as mp:
        out["host_reads"] = _host_read_checks(mesh, mp)
    return out


def _ranks(rank, world, store_path, root):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    root = Path(root)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        for name, shape in MESHES[world].items():
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            res = {"serve": _serve(mesh, root),
                   "train": _train(mesh, root, root / name),
                   "graph": _graph_checks(mesh, root)}
            if rank == 0:
                (root / f"{name}.json").write_text(json.dumps(res))
            _barrier()
    finally:
        dist.destroy_process_group()


def run_all(root) -> None:
    import torch.multiprocessing as mp
    root = Path(root)
    for world in MESHES:
        mp.spawn(_ranks, args=(world, str(root / f"store_{world}"),
                               str(root)), nprocs=world)


def load(root) -> dict:
    root = Path(root)
    return {name: json.loads((root / f"{name}.json").read_text())
            for meshes in MESHES.values() for name in meshes}


if __name__ == "__main__":
    run_all(sys.argv[1])
