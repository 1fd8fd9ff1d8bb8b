"""The port's dry run (``repro_torch.launch.dryrun``) held against the
reference's (``repro.launch.dryrun``), both run live.

The reference runs in a subprocess per cell (it sets ``XLA_FLAGS`` for
512 placeholder devices when imported), with ``make_production_mesh``
replaced by the same 16x16 mesh on ``Auto`` axes: on recent jax releases
``jax.make_mesh`` makes ``Explicit`` axes, which
``with_sharding_constraint`` refuses.  ``tests/data/
make_dryrun_reference.py`` holds that runner; it also writes the
committed fixture ``tests/data/dryrun_reference_pod16x16.json`` (every
pod16x16 cell), which one test here checks against the live run.  The
port runs ``run_cell`` in one subprocess (this file run as a script) with
its own fake process group.

Cells: gemma3-1b ``decode_32k`` (the cache's sequence split over
``model``: 4 heads on 1 KV head) and ``long_500k`` (batch 1, the sequence
split over data x model), and granite-moe-3b-a800m ``decode_32k`` (MoE).
Each takes a few seconds a side.  Per cell:

* **argument bytes ==.**  Both place the same parameters, token and
  cache by the same rules (the cache position counts as the reference's
  int32 scalar).
* **matrix-product FLOPs, dense cells: within 1%.**  Both count a matmul
  as 2 x M x N x K; the reference's ``dot`` FLOPs are parsed from its
  optimized HLO with the same E/B correction as its total.  (Measured:
  equal to the FLOP.)  The MoE cell is left to the total's bound: its
  dispatch is shaped differently by GSPMD and by the port's per-shard
  dispatch.
* **total FLOPs: port / reference in [0.5, 2].**  The port adds
  elementwise FLOPs by the rule of XLA's cost analysis, but XLA:CPU has
  no bf16 dot: it converts every bf16 weight and cache that feeds one to
  f32, and counts each converted element as a FLOP.  The card computes
  bf16 products natively and the port converts nothing, so at decode
  (one token a row, a weight read for few FLOPs) the reference counts up
  to ~2x the port's FLOPs (measured 0.58 on both gemma3 cells).
* **peak: port / (reference's peak less its f32 copies) in [0.5, 2].**
  The same float normalization makes XLA:CPU hold f32 copies of the bf16
  stacked weights and caches (decode_32k: f32 copies of the whole
  26-layer K/V cache), which is most of its temp.  The generator reads
  their size from the reference's own program (``f32_copy_bytes``: each
  bf16 argument that some f32 ``convert`` of the same dims copies) and
  the bound applies to what is left, which is what both hold: the
  arguments, the outputs, the transients.  Not every such copy is live
  at the reference's peak, so what is left is floored at what any
  program of the step holds: arguments plus outputs less the aliased
  (donated) bytes.
* **collective bytes of each kind: within 2x, or within 1 MiB.**  Both
  reduce decode attention over the cache's sequence shards (max, sum of
  exponentials, P.V) and gather the replicated logits.  No all-gather
  of the cache is left: the port's all-gather bytes are at most the
  replicated logits'.  Exceptions, named in ``OWN_BYTES``: granite's
  GSPMD program gathers the MoE dispatch slots, (8, 320, 1536) f32 a
  layer (503 of its 505 MiB), and all-reduces the experts' outputs (B',
  E, C, D) a layer (483 MiB); the port dispatches each batch shard where
  it lies, gathers only the logits, and combines each rank's experts
  before it reduces.  For those kinds the port is held within 2x of the
  reference above (at most 2x) and within 2x of its own figure, summed
  from the shapes of the collectives its design makes, both ways: the
  gathered logits (B, 1, V) f32; and a layer's combine, a (B', 1, D)
  partial sum in the activations' dtype, with its decode attention's
  reductions over the cache's shards, (B', 1, H, hd) f32 for P.V and
  two (B', H, 1, 1) f32 for the max and the sum of exponentials, times
  the layers, with the logits' (B', 1, V) f32 partial sum over
  ``model``'s slices of D (3.8 MiB in all).  B' is a data rank's rows.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests" / "data"))
import make_dryrun_reference  # noqa: E402

DENSE = (("gemma3-1b", "decode_32k"), ("gemma3-1b", "long_500k"))
CELLS = DENSE + (("granite-moe-3b-a800m", "decode_32k"),)
MiB = 2**20
#: data ranks of the pod16x16 mesh
DATA = 16


def _logits_bytes(cfg, shape):
    return shape.global_batch * cfg.vocab * 4


def _decode_all_reduce_bytes(cfg, shape):
    rows = shape.global_batch // DATA
    layer = rows * (cfg.d_model * 2 + cfg.n_heads * cfg.hd * 4
                    + 2 * cfg.n_heads * 4)
    return cfg.n_layers * layer + rows * cfg.vocab * 4


#: cells and collective kinds held to the port's own figure beside the
#: reference's upper side (see the module docstring)
OWN_BYTES = {("granite-moe-3b-a800m", "decode_32k"): {
    "all-gather": _logits_bytes, "all-reduce": _decode_all_reduce_bytes}}
FIXTURE = ROOT / "tests" / "data" / "dryrun_reference_pod16x16.json"


@pytest.fixture(scope="module")
def reference():
    with ThreadPoolExecutor(len(CELLS)) as pool:
        cells = list(pool.map(
            lambda c: make_dryrun_reference.reference_cell(*c, timeout=300),
            CELLS))
    return dict(zip(CELLS, cells))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = tmp_path_factory.mktemp("parity") / "port.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    cells = json.loads(out.read_text())
    return {tuple(k.split("__")): v for k, v in cells.items()}


@pytest.mark.parametrize("cell", CELLS, ids="__".join)
def test_argument_bytes_equal(reference, port, cell):
    ref, got = reference[cell], port[cell]
    assert ref["status"] == got["status"] == "ok", got.get("error")
    assert got["memory"]["argument_bytes"] == \
        ref["memory"]["argument_bytes"]


@pytest.mark.parametrize("cell", DENSE, ids="__".join)
def test_matmul_flops_equal_reference_dots(reference, port, cell):
    want = reference[cell]["cost"]["dot_flops_per_device"]
    got = port[cell]["cost"]["matmul_flops_per_device"]
    assert abs(got / want - 1) <= 0.01, (got, want)


@pytest.mark.parametrize("cell", CELLS, ids="__".join)
def test_flops_within_bound(reference, port, cell):
    ratio = port[cell]["cost"]["flops_per_device"] \
        / reference[cell]["cost"]["flops_per_device"]
    assert 0.5 <= ratio <= 2, ratio


@pytest.mark.parametrize("cell", CELLS, ids="__".join)
def test_peak_within_bound(reference, port, cell):
    from repro_torch.launch.dryrun import against_reference
    ratio = against_reference(port[cell], reference[cell])["peak_held"]
    assert 0.5 <= ratio <= 2, ratio


@pytest.mark.parametrize("cell", CELLS, ids="__".join)
def test_collectives_within_bound(reference, port, cell):
    ref = reference[cell]["cost"]["collective_bytes_per_device"]
    got = port[cell]["cost"]["collective_bytes_per_device"]
    for kind in set(ref) | set(got):
        r, g = ref.get(kind, 0.0), got.get(kind, 0.0)
        own = OWN_BYTES.get(cell, {}).get(kind)
        if own is not None:
            from repro_torch.configs import SHAPES, get_config
            o = own(get_config(cell[0]), SHAPES[cell[1]])
            assert g <= 2 * r and o / 2 <= g <= 2 * o, (kind, g, r, o)
            continue
        assert abs(g - r) <= MiB or r / 2 <= g <= 2 * r, (kind, g, r)


@pytest.mark.parametrize("cell", CELLS, ids="__".join)
def test_no_cache_all_gather(port, cell):
    """The only all-gather left is the logits' (B, 1, V) f32, replicated
    by the reference's out_shardings; the sequence-split cache is never
    gathered."""
    from repro_torch.configs import SHAPES, get_config
    cfg, shape = get_config(cell[0]), SHAPES[cell[1]]
    logits = shape.global_batch * cfg.vocab * 4
    gathered = port[cell]["cost"]["collective_bytes_per_device"].get(
        "all-gather", 0.0)
    assert gathered <= logits * 1.25, (gathered, logits)


@pytest.mark.parametrize("cell", DENSE, ids="__".join)
def test_fixture_equals_live_reference(reference, cell):
    cells = json.loads(FIXTURE.read_text())["cells"]
    assert cells["__".join(cell)] == reference[cell]


def test_fixture_covers_every_cell():
    from repro_torch.configs import SHAPES, all_archs
    data = json.loads(FIXTURE.read_text())
    assert data["generator"] == "tests/data/make_dryrun_reference.py"
    assert set(data["cells"]) == {f"{a}__{s}" for a in all_archs()
                                  for s in SHAPES}
    for cell in data["cells"].values():
        assert cell["mesh"] == "pod16x16"
        if cell["status"] == "ok":
            assert {"memory", "cost"} <= set(cell)


def _main(out_path):
    from repro_torch.launch import dryrun
    torch.set_num_threads(1)
    out = {f"{a}__{s}": dryrun.run_cell(a, s, False) for a, s in CELLS}
    Path(out_path).write_text(json.dumps(out))


if __name__ == "__main__":
    _main(sys.argv[1])
