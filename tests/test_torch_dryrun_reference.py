"""The reference's collective bytes counted from a one-layer base
(``tests/data/make_dryrun_reference.py``), the parity target of the
port's dry run, without compiling anything:

* ``weighted_collectives`` counts each collective once per run: a tuple
  all-reduce inside a while body of trip count 3 three times (the sum of
  its arrays each time), the collectives of the entry computation once;
* ``one_layer_base_total`` is ``(b + sum_i (n_i - 1) B_i) x
  microbatches`` by kind, a negative delta kept as it is;
* in the committed fixture, the FSDP train cells (qwen3-moe-235b-a22b,
  gemma2-27b) gather far more from a one-layer base than the reference's
  own count, whose 0-layer base moves more than its one-layer program
  and whose clamp then drops every layer; in the non-FSDP train cells
  the two counts agree;
* ``against_reference`` returns the one-layer base as the fourth figure
  of each kind, and the four totals."""

import json
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests" / "data"))
import make_dryrun_reference as gen  # noqa: E402

FIXTURE = ROOT / "tests" / "data" / "dryrun_reference_pod16x16.json"

#: a while loop of trip count 3 whose body all-reduces a tuple (f32[4],
#: bf16[8]: 16 + 16 bytes), and an all-gather (64 bytes) and an
#: all-reduce (16 bytes) in the entry computation
HLO = """HloModule m

%add (a: f32[], b: f32[]) -> f32[] {
  ROOT %s = f32[] add(%a, %b)
}

%body (p: (s32[], f32[4])) -> (s32[], f32[4]) {
  %ar = (f32[4]{0}, bf16[8]{0}) all-reduce(%x, %y), replica_groups={}, to_apply=%add
  ROOT %t = (s32[], f32[4]) tuple(%i, %x)
}

%cond (p: (s32[], f32[4])) -> pred[] {
  ROOT %c = pred[] compare(%i, %n), direction=LT
}

ENTRY %main (x: f32[4]) -> f32[4] {
  %w = (s32[], f32[4]{0}) while(%t0), condition=%cond, body=%body, backend_config={"known_trip_count":{"n":"3"}}
  %g = f32[16]{0} all-gather(%x), dimensions={0}
  ROOT %o = f32[4]{0} all-reduce(%x), to_apply=%add
}
"""


def test_weighted_collectives_count_loop_trips():
    assert gen.collectives(HLO) == {"all-reduce": 48.0, "all-gather": 64.0}
    assert gen.weighted_collectives(HLO) == {"all-reduce": 3 * 32 + 16.0,
                                             "all-gather": 64.0}


def test_weighted_collectives_nested_loops_multiply():
    """A loop of trip count 2 around the loop of trip count 3: its body's
    all-reduce runs 6 times."""
    outer = HLO.replace("ENTRY %main", "%inner") + """
%obody (p: (s32[], f32[4])) -> (s32[], f32[4]) {
  %c = f32[4]{0} call(%x), to_apply=%inner
  ROOT %t = (s32[], f32[4]) tuple(%i, %c)
}

ENTRY %main (x: f32[4]) -> f32[4] {
  ROOT %w = (s32[], f32[4]{0}) while(%t0), condition=%cond, body=%obody, backend_config={"known_trip_count":{"n":"2"}}
}
"""
    assert gen.weighted_collectives(outer) == {
        "all-reduce": 2 * (3 * 32 + 16.0), "all-gather": 2 * 64.0}


def test_one_layer_base_total_is_the_hand_sum():
    base = {"all-reduce": 10.0, "all-gather": 4.0}
    deltas = [{"all-reduce": 3.0, "all-gather": -0.5}, {"all-reduce": 2.0,
                                                        "all-to-all": 7.0}]
    got = gen.one_layer_base_total(base, deltas, [5, 1], 4)
    # segment 1 has one layer: its delta counts 0 times; the negative
    # delta is not clamped
    assert got == {"all-gather": (4 + 4 * -0.5) * 4,
                   "all-reduce": (10 + 4 * 3) * 4, "all-to-all": 0.0}


def _train_cost(arch):
    return json.loads(FIXTURE.read_text())["cells"][f"{arch}__train_4k"][
        "cost"]


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "gemma2-27b"])
def test_fsdp_train_cells_gather_more_from_a_one_layer_base(arch):
    """From a one-layer base the FSDP train cells move more than twice the
    clamped count in all, and gather more (qwen3-moe 46x, gemma2-27b
    1.55x: its 0-layer program already gathers 8,283 MiB a microbatch)."""
    cost = _train_cost(arch)
    base = cost["collective_bytes_one_layer_base"]
    clamped = cost["collective_bytes_with_tuples"]
    assert sum(base.values()) > 2 * sum(clamped.values())
    assert base["all-gather"] > clamped["all-gather"]
    if arch == "qwen3-moe-235b-a22b":
        assert base["all-gather"] > 2 * clamped["all-gather"]


@pytest.mark.parametrize("arch", ["gemma3-1b", "granite-moe-3b-a800m",
                                  "falcon-mamba-7b"])
def test_non_fsdp_train_cells_agree_with_the_clamped_count(arch):
    cost = _train_cost(arch)
    base = cost["collective_bytes_one_layer_base"]
    tuples = cost["collective_bytes_with_tuples"]
    total = sum(tuples.values())
    assert abs(sum(base.values()) / total - 1) <= 0.01
    for kind in set(base) | set(tuples):
        assert abs(base.get(kind, 0.0) - tuples.get(kind, 0.0)) \
            <= 0.01 * total, kind


def test_every_ok_cell_has_the_one_layer_base():
    for name, cell in json.loads(FIXTURE.read_text())["cells"].items():
        if cell["status"] == "ok":
            assert cell["cost"]["collective_bytes_one_layer_base"], name


def test_against_reference_returns_the_one_layer_base():
    from repro_torch.launch.dryrun import against_reference
    mem = {"peak_estimate_bytes": 100, "f32_copy_bytes": 20,
           "argument_bytes": 30, "output_bytes": 10, "alias_bytes": 5}
    ref = {"memory": mem, "cost": {
        "flops_per_device": 10.0, "dot_flops_per_device": 5.0,
        "collective_bytes_per_device": {"all-reduce": 4.0},
        "collective_bytes_with_tuples": {"all-reduce": 6.0},
        "collective_bytes_one_layer_base": {"all-reduce": 9.0,
                                            "all-gather": 2.0}}}
    art = {"memory": dict(mem, peak_estimate_bytes=40), "cost": {
        "flops_per_device": 20.0, "matmul_flops_per_device": 5.0,
        "collective_bytes_per_device": {"all-to-all": 3.0,
                                        "all-reduce": 5.0}}}
    r = against_reference(art, ref)
    assert r["collectives"] == {"all-gather": (0.0, 0.0, 0.0, 2.0),
                                "all-reduce": (5.0, 4.0, 6.0, 9.0),
                                "all-to-all": (3.0, 0.0, 0.0, 0.0)}
    assert r["total"] == (8.0, 4.0, 6.0, 11.0)
    assert r["peak_held"] == 40 / 80
