"""The port's dry run (``repro_torch.launch.dryrun``) and roofline
(``repro_torch.launch.roofline``):

* on a fake 1x1 mesh the dry run's per-device matrix-product FLOPs of a
  smoke train, prefill and decode step equal ``FlopCounterMode``'s count
  of the same step unsharded, and no collective is recorded;
* on a fake 2x2 mesh the argument bytes equal the sum of the local shard
  bytes computed from the sharding specs, and a train cell records
  collectives;
* a production cell (gemma3-1b decode_32k on the fake 16x16 mesh) ends
  ``ok`` in the reference's JSON layout, and a cell that
  ``shape_supported`` refuses is ``skipped``;
* on the fake 16x16 mesh at full width and cut depth (one layer per
  segment, one microbatch), no weight is gathered where the reference's
  GSPMD keeps it split: falcon-mamba's train step, and its prefill of
  prefill_32k's 2 x 32,768 tokens a rank, gather nothing as large as half
  of one layer's in-projection (its halves are exchanged, an
  all-to-all); gemma3-1b's train step (4 heads padded to 16) gathers
  nothing in its backward (the padded weights' gradients stay split);
  gemma2-27b's batch-1 decode (an ``fsdp`` arch) gathers less in the
  whole step than one layer's query projection holds on one rank;
  qwen3-moe's train step (one sequence a data rank) gathers nothing as
  large as one layer's dispatch slots on a rank, and in its backward no
  expert weight beyond its FSDP gather (the experts are exchanged, an
  all-to-all); the embedding lookup of qwen3-moe's and gemma2-27b's
  train microbatches (one and two sequences a data rank) keeps their
  ``fsdp`` tables split (the rows come back by an all-to-all);
* an ``fsdp`` product under a split batch (gemma2-27b's ``w_gate`` at
  decode_32k's and train_4k's rows a rank) takes the way
  ``sharding.gather_or_exchange`` names: at decode the rows move
  (all-to-all and reduce-scatter, nothing gathered), at train size the
  weight is gathered (one all-gather of its size);
* the reference's train-cell all-reduce counted with its tuple-shaped
  collectives, spread over its layers and microbatches, bounds gemma3-1b's
  one-layer microbatch of the same rows (4 a data rank);
* ``model_flops`` and ``fused_memory_bytes`` equal the reference's on all
  40 cells, and ``analyse`` equals the reference's on synthetic artifacts
  once the reference's constants are the port's.

The fake process groups open in a subprocess (this file run as a
script), never in a test worker."""

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


@pytest.fixture(scope="module")
def fake_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "result.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_one_device_flops_equal_unsharded(fake_results, mode):
    r = fake_results["1x1"][mode]
    assert r["flops"] > 0
    assert r["flops"] == r["unsharded_flops"]
    assert r["collectives"] == {}


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_argument_bytes_are_local_shard_bytes(fake_results, mode):
    r = fake_results["2x2"][mode]
    assert r["argument_bytes"] == r["spec_bytes"]
    assert r["argument_bytes"] < r["global_bytes"]
    assert r["peak"] >= r["argument_bytes"]


def test_train_cell_records_collectives(fake_results):
    coll = fake_results["2x2"]["train"]["collectives"]
    assert coll and all(v > 0 for v in coll.values()), coll


def test_production_cell_layout(fake_results):
    cell = fake_results["production"]
    assert cell["status"] == "ok", cell.get("error")
    assert cell["devices"] == 256 and cell["mesh"] == "pod16x16"
    assert set(cell["memory"]) == {"argument_bytes", "output_bytes",
                                   "temp_bytes", "alias_bytes",
                                   "peak_estimate_bytes"}
    assert set(cell["cost"]) == {"n_microbatches", "flops_per_device",
                                 "matmul_flops_per_device",
                                 "bytes_per_device",
                                 "collective_bytes_per_device", "segments"}
    assert cell["cost"]["flops_per_device"] > 0
    assert fake_results["skipped"]["status"] == "skipped"


def test_falcon_mamba_cut_train_gathers_no_in_projection(fake_results):
    r = fake_results["mechanisms"]["falcon_train"]
    assert max(n for n, _ in r["gathers"]) < r["w_in_half"], r
    assert r["kinds"].get("all-to-all", 0) > 0, r["kinds"]


def test_gemma3_cut_train_gathers_no_padded_gradient(fake_results):
    r = fake_results["mechanisms"]["gemma3_train"]
    assert [n for n, backward in r["gathers"] if backward] == [], r


def test_gemma2_cut_batch1_decode_gathers_no_fsdp_weight(fake_results):
    r = fake_results["mechanisms"]["gemma2_long"]
    assert sum(n for n, _ in r["gathers"]) < r["wq_shard"], r


def test_qwen3_moe_cut_train_gathers_no_dispatch_slots(fake_results):
    r = fake_results["mechanisms"]["qwen3_train"]
    assert max(n for n, _ in r["gathers"]) < r["slots_rank"], r
    # the backward gathers no expert weight beyond its FSDP gather
    assert max((n for n, backward in r["gathers"] if backward),
               default=0) <= r["expert_gathered"], r
    assert r["kinds"].get("all-to-all", 0) > 0, r["kinds"]


@pytest.mark.parametrize("cell", ["qwen3_train", "gemma2_train"])
def test_fsdp_cut_train_lookup_gathers_no_table(fake_results, cell):
    """An ``fsdp`` embedding table (vocabulary over ``model``, D over
    ``data``) under train_4k's data-split microbatch keeps its D split:
    ``gather_or_exchange`` moves the rows (the ids are gathered, a
    data rank's rows come back by one all-to-all), and the lookup gathers
    nothing as large as (data - 1) x the table's shard on a rank."""
    r = fake_results["mechanisms"][cell]
    assert r["lookups"] == {"exchange": 1}, r["lookups"]
    gathers = [n for kind, n in r["lookup_collectives"]
               if kind == "all-gather"]
    assert max(gathers) < (r["data"] - 1) * r["table_shard"], \
        r["lookup_collectives"]
    assert ["all-to-all", r["rows_rank"]] in [
        list(c) for c in r["lookup_collectives"]], r["lookup_collectives"]


def test_falcon_mamba_cut_prefill_gathers_no_in_projection(fake_results):
    r = fake_results["mechanisms"]["falcon_prefill"]
    assert max((n for n, _ in r["gathers"]), default=0) < r["w_in_half"], r
    assert r["kinds"].get("all-to-all", 0) > 0, r["kinds"]


@pytest.mark.parametrize("batch", ["decode", "train"])
def test_fsdp_product_takes_the_way_the_rule_names(fake_results, batch):
    r = fake_results["mechanisms"]["fsdp_ways"][batch]
    assert r["named"] == {"decode": "exchange", "train": "gather"}[batch]
    if r["named"] == "gather":
        assert [n for n, _ in r["gathers"]] == [r["w_gathered"]], r
        assert "all-to-all" not in r["kinds"], r
    else:
        assert r["gathers"] == [], r
        assert r["kinds"].get("all-to-all", 0) > 0, r
        assert r["kinds"].get("reduce-scatter", 0) > 0, r


def test_gemma3_cut_train_all_reduce_within_reference_with_tuples(
        fake_results):
    """The reference's train-cell all-reduce counted with its
    tuple-shaped collectives (``collective_bytes_with_tuples``; its
    ``parse_collectives`` misses them), spread over its layers and
    microbatches, bounds the port's one-layer microbatch of the same rows
    (4 a data rank), which counts in full the step's once-a-step
    collectives (the optimizer's, the outputs' placement) and the
    microbatch's embedding and head besides its one layer."""
    from repro_torch.configs import get_config
    ref = json.loads((ROOT / "tests" / "data" /
                      "dryrun_reference_pod16x16.json").read_text())
    cost = ref["cells"]["gemma3-1b__train_4k"]["cost"]
    layers = sum(seg.n for seg in get_config("gemma3-1b").segments)
    bound = cost["collective_bytes_with_tuples"]["all-reduce"] / (
        layers * cost["n_microbatches"])
    got = fake_results["mechanisms"]["gemma3_train"]["kinds"]["all-reduce"]
    assert got <= bound, (got, bound)


def test_parse_collectives_sums_by_kind():
    from repro_torch.launch.dryrun import parse_collectives
    got = parse_collectives([("all-reduce", 8.0), ("all-gather", 4.0),
                             ("all-reduce", 2.0)])
    assert got == {"all-reduce": 10.0, "all-gather": 4.0}
    assert parse_collectives([]) == {}


# ---------------------------------------------------------------------------
# roofline against the reference
# ---------------------------------------------------------------------------

@pytest.fixture()
def cached_counts(monkeypatch):
    """Both packages' ``param_count`` memoised (the reference's traces the
    whole init for each call)."""
    from repro.launch import roofline as jroofline
    from repro_torch.launch import roofline
    monkeypatch.setattr(jroofline.transformer, "param_count",
                        _memo(jroofline.transformer.param_count))
    monkeypatch.setattr(roofline.transformer, "param_count",
                        _memo(roofline.transformer.param_count))


@functools.lru_cache(maxsize=None)
def _memo(fn):
    return functools.lru_cache(maxsize=None)(fn)


def _archs():
    from repro_torch.configs import all_archs
    return all_archs()


@pytest.mark.parametrize("arch", _archs())
def test_model_flops_and_fused_bytes_equal_reference(cached_counts, arch):
    from repro.launch import roofline as jroofline
    from repro_torch.configs import SHAPES
    from repro_torch.launch import roofline
    for shape in SHAPES:
        assert roofline.model_flops(arch, shape) == \
            jroofline.model_flops(arch, shape), shape
        assert roofline.fused_memory_bytes(arch, shape) == \
            jroofline.fused_memory_bytes(arch, shape), shape


def _artifact(arch, shape, i):
    return {"arch": arch, "shape": shape, "status": "ok", "devices": 256,
            "memory": {"peak_estimate_bytes": 3 * 2**30 + i},
            "cost": {"flops_per_device": 1.5e13 * (i + 1),
                     "bytes_per_device": 2.0e11 / (i + 1),
                     "collective_bytes_per_device": {
                         "all-reduce": 3.0e9 * i, "all-gather": 1.0e9}}}


def test_analyse_equals_reference_with_the_same_constants(cached_counts,
                                                          monkeypatch):
    from repro.launch import roofline as jroofline
    from repro_torch.launch import roofline
    monkeypatch.setattr(jroofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jroofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(jroofline, "ICI_LINK_BW", roofline.NVLINK_LINK_BW)
    monkeypatch.setattr(jroofline, "ICI_LINKS", roofline.NVLINK_LINKS)
    cases = [_artifact("gemma3-1b", "train_4k", 0),
             _artifact("granite-moe-3b-a800m", "prefill_32k", 1),
             _artifact("qwen3-moe-235b-a22b", "decode_32k", 2),
             _artifact("whisper-small", "train_4k", 3),
             {"arch": "gemma3-1b", "shape": "long_500k", "status": "skipped",
              "reason": "why"},
             {"arch": "stablelm-1.6b", "shape": "train_4k", "status": "failed",
              "error": "RuntimeError: x"},
             {"arch": "stablelm-1.6b", "shape": "train_4k", "status": "ok",
              "devices": 256, "memory": {"peak_estimate_bytes": 1}}]
    for art in cases:
        assert dataclasses.asdict(roofline.analyse(art)) == \
            dataclasses.asdict(jroofline.analyse(art)), art


def test_h100_constants():
    from repro_torch.launch import roofline
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.NVLINK_LINK_BW * roofline.NVLINK_LINKS == 450e9


def test_load_rows_reads_the_artifacts(cached_counts, monkeypatch, tmp_path):
    from repro_torch.launch import roofline
    monkeypatch.setattr(roofline, "ART_DIR", str(tmp_path))
    art = _artifact("gemma3-1b", "train_4k", 0)
    (tmp_path / "gemma3-1b__train_4k__pod16x16.json").write_text(
        json.dumps(art))
    rows = roofline.load_rows()
    assert len(rows) == 40
    got = {(r.arch, r.shape): r for r in rows}
    assert got[("gemma3-1b", "train_4k")] == roofline.analyse(art)
    assert sum(r.status == "missing" for r in rows) == 39


# ---------------------------------------------------------------------------
# the subprocess: fake process groups
# ---------------------------------------------------------------------------

def _smoke_cells():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").smoke(),
                              microbatch=2)
    return cfg, {"train": ShapeSpec("t", 16, 4, "train"),
                 "prefill": ShapeSpec("p", 16, 4, "prefill"),
                 "decode": ShapeSpec("d", 16, 4, "decode")}


def _unsharded_flops(cfg, shape):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import dryrun
    from repro_torch.models.lm import model
    with FakeTensorMode():
        params = dryrun._fake(model.abstract_params(cfg))
        batch = dryrun._fake(dryrun._meta(model.make_batch_spec(cfg, shape)))
        if shape.mode == "train":
            args = (params, dryrun._fake(model.abstract_opt_state(cfg)), batch)
            step = model.make_train_step(cfg)
        elif shape.mode == "prefill":
            args, step = (params, batch), model.make_prefill_step(
                cfg, s_max=shape.seq_len)
        else:
            cache = dryrun._fake(dryrun._meta(model.init_cache_spec(cfg,
                                                                   shape)))
            args = (params, batch["token"],
                    cache._replace(cur_pos=shape.seq_len - 1))
            step = model.make_decode_step(cfg)
        counter = FlopCounterMode(display=False)
        with counter:
            step(*args)
    return counter.get_total_flops()


def _spec_bytes(cfg, shape, mesh):
    """(local, global) bytes of the cell's arguments from the specs (the
    cache's position, a host int in the port, counts as the reference's
    int32 scalar)."""
    from repro_torch.launch import dryrun
    from repro_torch.models.lm import model, sharding
    from repro_torch.tree import tree_leaves
    aparams = model.abstract_params(cfg)
    batch = dryrun._meta(model.make_batch_spec(cfg, shape))
    trees = [(aparams, sharding.param_shardings(cfg, mesh, aparams)),
             (batch, sharding.batch_shardings(mesh, batch))]
    if shape.mode == "train":
        aopt = model.abstract_opt_state(cfg)
        trees.append((aopt, sharding.opt_shardings(cfg, mesh, aopt, aparams)))
    if shape.mode == "decode":
        cache = dryrun._meta(model.init_cache_spec(cfg, shape))
        trees = trees[:1] + [({"token": batch["token"]},
                              sharding.batch_shardings(mesh, batch)),
                             (cache.entries, sharding.cache_shardings(
                                 mesh, cache).entries)]
    sizes = sharding.mesh_axes(mesh)
    local = total = 4 if shape.mode == "decode" else 0
    for tree, shard in trees:
        for t, s in zip(tree_leaves(tree), tree_leaves(shard)):
            n = t.numel() * t.element_size()
            total += n
            for axes in s.spec:
                for a in ((axes,) if isinstance(axes, str) else axes or ()):
                    n //= sizes[a]
            local += n
    return local, total


#: cut-depth production cells on the fake 16x16 mesh: arch, shape, config
#: overrides (one layer per segment besides)
MECHANISM_CELLS = {
    "falcon_train": ("falcon-mamba-7b", ("t", 2048, 16, "train"),
                     {"microbatch": 16}),
    # train_4k's own microbatch: 64 rows, 4 a data rank
    "gemma3_train": ("gemma3-1b", ("t", 4096, 64, "train"), {}),
    "gemma2_long": ("gemma2-27b", ("long_500k", 524_288, 1, "decode"), {}),
    # train_4k's microbatch of 16 rows, one a data rank
    "qwen3_train": ("qwen3-moe-235b-a22b", ("t", 4096, 16, "train"), {}),
    # train_4k's microbatch of 32 rows, two a data rank
    "gemma2_train": ("gemma2-27b", ("t", 4096, 32, "train"), {}),
    # prefill_32k's 2 x 32,768 tokens a data rank
    "falcon_prefill": ("falcon-mamba-7b", ("p", 32_768, 32, "prefill"), {}),
}


def _mechanisms():
    """Each ``MECHANISM_CELLS`` cell's step under a ``CostMode`` that also
    notes, for every all-gather, its bytes and whether autograd's backward
    issued it, and the collectives that the embedding lookup's forward
    (``sharding.lookup_rows``) issued; with the byte sizes the checks
    compare against."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.models.lm import moe, sharding

    class Spy(dryrun.CostMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen = len(self.collectives)
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented and func._schema.name == \
                    "_c10d_functional::all_gather_into_tensor":
                self.gathers.append((out.numel() * out.element_size(),
                                     torch._C._current_autograd_node()
                                     is not None))
            if Spy.in_lookup:
                Spy.lookup += self.collectives[seen:]
            return out

    real_lookup = sharding.lookup_rows

    def lookup(table, idx):
        Spy.in_lookup = True
        try:
            return real_lookup(table, idx)
        finally:
            Spy.in_lookup = False

    Spy.gathers, Spy.lookup, Spy.in_lookup = [], [], False
    mesh = dryrun._fake_mesh(False)
    model_size = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    data_size = dict(zip(mesh.mesh_dim_names, mesh.shape))["data"]
    real = dryrun.CostMode
    dryrun.CostMode = Spy
    sharding.lookup_rows = lookup
    out = {}
    try:
        for name, (arch, dims, over) in MECHANISM_CELLS.items():
            cfg = get_config(arch)
            cfg = dataclasses.replace(cfg, segments=tuple(
                dataclasses.replace(s, n=1) for s in cfg.segments), **over)
            Spy.gathers, Spy.lookup = [], []
            shape = ShapeSpec(*dims)
            mode, _, _ = dryrun._measure(cfg, shape, mesh)
            rows = shape.global_batch // data_size * shape.seq_len
            out[name] = {
                "gathers": Spy.gathers,
                "kinds": dryrun.parse_collectives(mode.collectives),
                "lookups": mode.lookups,
                "lookup_collectives": Spy.lookup,
                # the embedding table's bf16 shard on a rank, (V / model,
                # D / data), and a data rank's looked-up rows, (B' S, D)
                "table_shard": cfg.vocab // model_size * cfg.d_model
                // data_size * 2,
                "rows_rank": rows * cfg.d_model * 2, "data": data_size,
                # bf16 weights of one layer
                "w_in_half": cfg.d_model * cfg.d_inner * 2,
                "wq_shard": cfg.d_model * cfg.n_heads * cfg.hd * 2
                // model_size}
            if cfg.n_experts:
                # one layer's dispatch slots on a rank, (B' / dp, E, C,
                # D), and one expert weight gathered whole along D, bf16
                C = moe.capacity(min(shape.seq_len, moe.GROUP),
                                 cfg.n_experts, cfg.top_k)
                out[name]["slots_rank"] = (shape.global_batch // data_size
                                           * cfg.n_experts * C
                                           * cfg.d_model * 2)
                out[name]["expert_gathered"] = (cfg.n_experts // model_size
                                                * cfg.d_model * cfg.d_ff * 2)
        out["fsdp_ways"] = _fsdp_ways(mesh, Spy)
    finally:
        dryrun.CostMode = real
        sharding.lookup_rows = real_lookup
    return out


#: decode_32k's and train_4k's rows of gemma2-27b (an fsdp arch): 128
#: one-token rows, and a microbatch of 16 rows of 4,096 tokens
FSDP_BATCHES = {"decode": (128, 1), "train": (16, 4096)}


def _fsdp_ways(mesh, spy):
    """gemma2-27b's ``w_gate`` (D, F), placed by its rules (D over
    ``data``, F over ``model``), times each ``FSDP_BATCHES`` batch of bf16
    rows split over ``data``, under ``spy`` (a ``CostMode`` noting every
    all-gather): the way ``gather_or_exchange`` names from
    ``matmul_bytes``, the collectives the product issued, and the
    weight's bytes gathered whole along D."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.lm import sharding
    cfg = get_config("gemma2-27b")
    D, F = cfg.d_model, cfg.d_ff
    sizes = sharding.mesh_axes(mesh)
    n, m = sizes["data"], sizes["model"]
    out = {}
    with FakeTensorMode():
        w = distribute_tensor(torch.empty(D, F, dtype=torch.bfloat16), mesh,
                              sharding.NamedSharding(
                                  mesh, sharding.param_pspec(
                                      cfg, mesh, ("w_gate",),
                                      torch.empty(D, F))).placements)
        for name, (B, S) in FSDP_BATCHES.items():
            x = distribute_tensor(torch.empty(B, S, D, dtype=torch.bfloat16),
                                  mesh, sharding.NamedSharding(
                                      mesh, sharding.P("data")).placements)
            spy.gathers = []
            mode = spy()
            with mode:
                sharding.matmul(x, w)
            out[name] = {
                "named": sharding.gather_or_exchange(*sharding.matmul_bytes(
                    B // n * S * D * 2, D // n * F // m * 2,
                    B // n * S * F // m * 2, n, 0)),
                "kinds": dryrun.parse_collectives(mode.collectives),
                "gathers": spy.gathers,
                "w_gathered": D * F // m * 2}
    return out


def _main(out_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    cfg, shapes = _smoke_cells()
    out = {}
    for name, dims in (("1x1", (1, 1)), ("2x2", (2, 2))):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=dims[0] * dims[1])
        mesh = init_device_mesh("cpu", dims, mesh_dim_names=("data", "model"))
        out[name] = {}
        for mode, shape in shapes.items():
            if name == "1x1":
                cost = dryrun.corrected_costs(cfg, shape, mesh)
                out[name][mode] = {
                    "flops": cost["matmul_flops_per_device"],
                    "collectives": cost["collective_bytes_per_device"],
                    "unsharded_flops": _unsharded_flops(cfg, shape)}
                continue
            cost_mode, memory, _ = dryrun._measure(cfg, shape, mesh)
            local, total = _spec_bytes(cfg, shape, mesh)
            out[name][mode] = {
                "collectives": dryrun.parse_collectives(
                    cost_mode.collectives),
                "argument_bytes": memory["argument_bytes"],
                "peak": memory["peak_estimate_bytes"],
                "spec_bytes": local, "global_bytes": total}
        dist.destroy_process_group()
    out["production"] = dryrun.run_cell("gemma3-1b", "decode_32k", False)
    out["skipped"] = dryrun.run_cell("granite-moe-3b-a800m", "long_500k",
                                     False)
    out["mechanisms"] = _mechanisms()
    Path(out_path).write_text(json.dumps(out))


if __name__ == "__main__":
    _main(sys.argv[1])
