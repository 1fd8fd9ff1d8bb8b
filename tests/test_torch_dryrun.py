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
    Path(out_path).write_text(json.dumps(out))


if __name__ == "__main__":
    _main(sys.argv[1])
