"""Multi-pod dry run: run every (architecture x input shape) step on the
production meshes of placeholder ranks, and record its per-device memory,
FLOPs, bytes and collectives.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell for 512 placeholder XLA devices.  PyTorch compiles nothing, so the
port runs the step itself, the PyTorch way:

* the process opens a fake process group (``FakeStore``, backend
  ``"fake"``) of 256 or 512 ranks and builds the production mesh on
  device type ``"cpu"``: every collective returns at once and moves
  nothing, so one process plays rank 0 of the mesh;
* under ``FakeTensorMode`` no tensor holds data: the abstract parameters,
  optimizer state, batch and cache are placed by the sharding rules
  (``sharding.distribute``) as DTensors of fake local shards, and the
  cell's step runs eagerly under ``sharding.activation_mesh``
  (``train_4k``: the train step, forward, backward and AdamW, with its
  microbatches; prefill and decode: their serving steps), and places its
  outputs as the reference's ``out_shardings`` do.  CPU tensors send
  ``kernels.ops.attention`` to its plain version (q-chunked from 8,192
  tokens, as the reference's ``forward``), so attention's FLOPs are the
  reference's jnp ``attend``;
* ``CostMode``, a dispatch mode under the DTensors, sees every local aten
  op that rank 0 runs, with its local shapes.

Per cell this writes ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``
in the reference's layout: ``status`` (``ok``, ``skipped`` by
``shape_supported``, or ``failed`` with the error and traceback, written
as data; the command exits 1 at the end if any cell failed), ``memory``
(per-device argument and output bytes, exact from the local shard sizes,
and the peak of live local storage that ``CostMode`` tracks under fake
tensors; a cache position counts as the reference's int32 scalar) and
``cost`` (FLOPs by the reference's rule, matrix products and
elementwise ops, with the matrix products' share apart; bytes accessed
and collective bytes per device).  A decode cell runs one step at
position ``seq_len - 1`` of a cache of ``seq_len``: the reference's
abstract cache position has no value, and the port's decode refuses a
position past its cache.  ``tests/test_torch_dryrun_parity.py`` holds
these figures against the reference's.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--force]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import weakref
from typing import Dict, Iterable, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..configs import SHAPES, all_archs, get_config
from ..configs.base import LMConfig, ShapeSpec, shape_supported
from ..models.lm import model, sharding
from ..tree import tree_leaves, tree_map
from .mesh import make_production_mesh

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")

#: functional collectives -> the reference's HLO collective kinds
_COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def parse_collectives(records: Iterable[Tuple[str, float]]) -> Dict[str, float]:
    """Sum result bytes per collective kind from ``(kind, bytes)``
    records, one per collective ``CostMode`` saw dispatched.

    The reference parses XLA's optimized HLO text for its collectives.
    PyTorch has no compiled program to read: DTensor issues each
    collective (a ``_c10d_functional`` op) eagerly where it redistributes,
    so the port counts them where they are dispatched."""
    out: Dict[str, float] = {}
    for kind, n_bytes in records:
        out[kind] = out.get(kind, 0.0) + n_bytes
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _in_sharding_propagation() -> bool:
    """Whether this op was issued by DTensor's sharding propagation, which
    runs ops on fake tensors of global shape to learn output metadata: no
    rank runs those."""
    f = sys._getframe(2)
    while f is not None:
        if "_sharding_prop" in f.f_code.co_filename:
            return True
        f = f.f_back
    return False


#: pointwise ops that move data and compute nothing (XLA counts no FLOPs
#: for copies), and the transcendentals, which XLA's cost analysis counts
#: apart from its FLOPs
_NO_FLOP_POINTWISE = frozenset({
    "clone", "copy", "copy_", "fill", "fill_", "zero_", "lift_fresh",
    "exp", "exp_", "exp2", "expm1", "log", "log_", "log2", "log10", "log1p",
    "tanh", "tanh_", "rsqrt", "sqrt", "sin", "cos", "tan", "sigmoid", "erf",
    "erfinv", "pow", "atan2", "logit"})


def _elementwise_flops(func, args, kwargs, outs) -> float:
    """FLOPs of one op by the rule of XLA's ``HloCostAnalysis``, whose
    count the reference's dry run reports: one per output element of an
    arithmetic elementwise op (a compare, a select and a dtype conversion
    included), one per input element of a reduction; none for data
    movement or transcendentals."""
    name = func._schema.name.split("::")[-1]
    if torch.Tag.pointwise in func.tags:
        if name in _NO_FLOP_POINTWISE:
            return 0.0
        return float(sum(t.numel() for t in outs))
    if torch.Tag.reduction in func.tags:
        ins = _tensors((args, kwargs))
        return float(ins[0].numel()) if ins else 0.0
    if name == "_to_copy" and outs:
        src = _tensors(args)
        if src and src[0].dtype != outs[0].dtype:
            return float(outs[0].numel())
    return 0.0


class CostMode(TorchDispatchMode):
    """Counts the local aten ops that this rank runs beneath the DTensors
    (DTensor-level ops are passed on with ``NotImplemented``, so each is
    seen once, as the local op it becomes):

    * ``flops``: ``torch.utils.flop_counter``'s count of each local op
      (matrix products and convolutions; FlopCounterMode around DTensor
      code would count the global op);
    * ``elementwise``: the other ops' FLOPs by the rule of XLA's cost
      analysis (``_elementwise_flops``), so that ``flops + elementwise``
      counts what the reference's ``flops`` counts;
    * ``bytes``: operand plus result bytes of every local op that is not
      a view, which is what XLA:CPU's pre-fusion "bytes accessed" counts;
    * ``collectives``: ``(kind, result bytes)`` of each functional
      collective;
    * ``live``/``peak``: bytes of live local storage, each new storage
      added when an op returns it and dropped by a finalizer when it is
      freed (a fake tensor's storage has a size and no data), so the peak
      is that of this rank under the step's own allocation order;
    * ``read``: the storages some op other than a view took as an
      input, so that an argument the step never reads (whisper's encoder
      at decode) is not counted, as ``jax.jit`` prunes unused arguments
      from the reference's program.
    """

    def __init__(self, count: bool = True) -> None:
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.count = count
        self.flops = 0.0
        self.elementwise = 0.0
        self.bytes = 0.0
        self.collectives: list = []
        self.live = 0
        self.peak = 0
        self.read: set = set()
        self._storages: Dict[int, int] = {}

    def track(self, tensors) -> None:
        """Count the storages of ``tensors`` (local tensors) as live."""
        for t in tensors:
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self.live += n
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_sharding_propagation():
            return out
        fresh = all(r.alias_info is None for r in func._schema.returns)
        outs = _tensors(out)
        # an op that computes (not a view, not a metadata query)
        computes = bool(outs) and (fresh or func._schema.is_mutable)
        if computes:
            self.read.update(id(t.untyped_storage())
                             for t in _tensors((args, kwargs)))
        name = func._schema.name
        if name.startswith("_c10d_functional::"):
            kind = name.split("::")[1]
            if kind != "wait_tensor" and self.count:
                self.collectives.append((_COLLECTIVE_KINDS.get(
                    kind, kind), float(sum(_nbytes(t) for t in outs))))
        elif self.count and computes:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in outs)
            packet = func._overloadpacket
            if packet in self.flop_registry:
                self.flops += self.flop_registry[packet](*args, **kwargs,
                                                         out_val=out)
            else:
                self.elementwise += _elementwise_flops(func, args, kwargs,
                                                       outs)
        if fresh:
            self.track(outs)
        return out


# ---------------------------------------------------------------------------
# cell construction
# ---------------------------------------------------------------------------

def _local(tree) -> list:
    """Local shards of every DTensor leaf of ``tree``."""
    from torch.distributed.tensor import DTensor
    return [x.to_local() for x in tree_leaves(tree) if isinstance(x, DTensor)]


def _meta(tree):
    """``tree`` with every ``TensorSpec`` leaf (a NamedTuple, which the
    port's tree walk would open) replaced by a meta tensor."""
    if isinstance(tree, model.TensorSpec):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_meta(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_meta(v) for v in tree)
    return tree


def _fake(meta_tree):
    """Fake tensors (no data; inside ``FakeTensorMode``) shaped like the
    meta tensors of ``meta_tree``."""
    return tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype), meta_tree)


def build_step(cfg: LMConfig, shape: ShapeSpec, mesh):
    """Returns (step, args) for the cell: ``args`` placed by the sharding
    rules as DTensors of fake shards (call inside ``FakeTensorMode``).
    The step places its outputs as the reference's ``jax.jit`` does by its
    ``out_shardings``: parameters and optimizer state by the rules, a
    cache by ``cache_shardings``, logits and metrics replicated (which
    gathers the logits onto every rank, as the reference's program
    does)."""
    rep = sharding.replicated(mesh)
    aparams = model.abstract_params(cfg)
    ps = sharding.param_shardings(cfg, mesh, aparams)
    params = sharding.distribute(_fake(aparams), ps)
    batch_spec = _meta(model.make_batch_spec(cfg, shape))
    batch = sharding.distribute(_fake(batch_spec), sharding.batch_shardings(
        mesh, batch_spec))

    def placed(step, out_shardings):
        """``step`` with each output placed by its sharding tree (or by
        the tree a callable makes of the output: the metrics dict)."""
        def run(*args):
            outs = step(*args)
            return tuple(sharding.distribute(o, s(o) if callable(s) else s)
                         for o, s in zip(outs, out_shardings))
        return run

    if shape.mode == "train":
        aopt = model.abstract_opt_state(cfg)
        os_ = sharding.opt_shardings(cfg, mesh, aopt, aparams)
        opt = sharding.distribute(_fake(aopt), os_)
        met = lambda m: {k: rep for k in m}  # noqa: E731
        return placed(model.make_train_step(cfg, mesh=mesh),
                      (ps, os_, met)), (params, opt, batch)
    acache = _meta(model.init_cache_spec(cfg, shape))
    cs = sharding.cache_shardings(mesh, acache)
    if shape.mode == "prefill":
        return placed(model.make_prefill_step(cfg, s_max=shape.seq_len),
                      (rep, cs)), (params, batch)
    cache = sharding.distribute(_fake(acache), cs)
    cache = cache._replace(cur_pos=shape.seq_len - 1)
    return placed(model.make_decode_step(cfg), (rep, cs)), (
        params, batch["token"], cache)


def _position_bytes(tree) -> int:
    """Bytes of the reference's int32 cache positions in ``tree``: a
    ``ServeCache``'s ``cur_pos`` is a host int here and a device scalar
    argument and result there."""
    return sum(4 for x in tree_leaves(tree) if type(x) is int)


def _measure(cfg: LMConfig, shape: ShapeSpec, mesh, count: bool = True):
    """Run the cell's step once under ``CostMode``; returns (mode, memory
    record, seconds)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        step, args = build_step(cfg, shape, mesh)
        mode = CostMode(count=count)
        arg_local = _local(args)
        mode.track(arg_local)
        t0 = time.perf_counter()
        with sharding.activation_mesh(mesh), mode:
            outs = step(*args)
        seconds = time.perf_counter() - t0
        out_local = _local(outs)
        arg_ids = {id(t.untyped_storage()) for t in arg_local}
        positions = _position_bytes(args)
        argument = sum(_nbytes(t) for t in arg_local
                       if id(t.untyped_storage()) in mode.read) + positions
        output = sum(_nbytes(t) for t in out_local) + _position_bytes(outs)
        alias = sum(_nbytes(t) for t in out_local
                    if id(t.untyped_storage()) in arg_ids) + positions
        peak = mode.peak
        del outs, args
    return mode, {
        "argument_bytes": argument,
        "output_bytes": output,
        "temp_bytes": max(peak - argument - output + alias, 0),
        "alias_bytes": alias,
        "peak_estimate_bytes": peak,
    }, seconds


def _n_microbatches(cfg: LMConfig, shape: ShapeSpec) -> int:
    if shape.mode != "train":
        return 1
    return max(shape.global_batch // min(cfg.microbatch, shape.global_batch),
               1)


def _cost(cfg: LMConfig, shape: ShapeSpec, mode: CostMode) -> Dict:
    return {
        "n_microbatches": _n_microbatches(cfg, shape),
        "flops_per_device": mode.flops + mode.elementwise,
        "matmul_flops_per_device": mode.flops,
        "bytes_per_device": mode.bytes,
        "collective_bytes_per_device": parse_collectives(mode.collectives),
        "segments": [],
    }


def corrected_costs(cfg: LMConfig, shape: ShapeSpec, mesh) -> Dict:
    """FLOPs, bytes and collective bytes per device of the cell's step, in
    the reference's layout.

    The reference needs an E/B decomposition (a 0-layer program plus one
    layer of each segment, scaled by the layer counts and microbatches)
    because XLA's cost analysis counts a rolled scan body once.  PyTorch
    runs every layer and every microbatch eagerly, so the port counts
    them directly: nothing is scaled, and ``segments`` (the reference's
    per-segment bodies) is empty."""
    mode, _, _ = _measure(cfg, shape, mesh)
    return _cost(cfg, shape, mode)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             with_cost: bool = True) -> Dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    ok, reason = shape_supported(cfg, shape)
    result: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if not ok:
        result.update(status="skipped", reason=reason)
        return result
    mesh = _fake_mesh(multi_pod)
    mode, memory, seconds = _measure(cfg, shape, mesh, count=with_cost)
    result.update(status="ok", step_seconds=seconds, devices=mesh.size(),
                  memory=memory)
    if with_cost:
        result["cost"] = _cost(cfg, shape, mode)
    return result


def _fake_mesh(multi_pod: bool):
    """The production mesh over a fake process group of its size, opened
    here (and reopened when the size changes)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = 512 if multi_pod else 256
    if dist.is_initialized() and dist.get_world_size() != n:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def against_reference(art: Dict, ref: Dict) -> Dict:
    """Port / reference ratios of one cell: ``art`` a cell of this dry run,
    ``ref`` the reference's (``tests/data/dryrun_reference_pod16x16.json``,
    whose generator adds ``f32_copy_bytes``, ``dot_flops_per_device`` and
    ``collective_bytes_with_tuples`` from the reference's own programs).
    ``peak_held`` divides by the reference's peak less the f32 copies
    XLA:CPU makes of its bf16 arguments, floored at what any program of
    the step holds (arguments + outputs - aliased); ``matmul_flops``
    divides the matrix products' FLOPs by the reference's ``dot`` FLOPs;
    ``collectives`` maps each kind to (port, reference, reference with
    its tuple-shaped collectives) bytes."""
    mem, cost = ref["memory"], ref["cost"]
    held = max(mem["peak_estimate_bytes"] - mem["f32_copy_bytes"],
               mem["argument_bytes"] + mem["output_bytes"]
               - mem["alias_bytes"])
    peak = art["memory"]["peak_estimate_bytes"]
    got = art["cost"]["collective_bytes_per_device"]
    want = cost["collective_bytes_per_device"]
    tuples = cost["collective_bytes_with_tuples"]
    return {
        "peak": peak / mem["peak_estimate_bytes"], "peak_held": peak / held,
        "flops": art["cost"]["flops_per_device"] / cost["flops_per_device"],
        "matmul_flops": art["cost"]["matmul_flops_per_device"]
        / cost["dot_flops_per_device"],
        "argument_equal": art["memory"]["argument_bytes"]
        == mem["argument_bytes"],
        "collectives": {k: (got.get(k, 0.0), want.get(k, 0.0),
                            tuples.get(k, 0.0))
                        for k in sorted(set(got) | set(want) | set(tuples))}}


def cell_path(arch: str, shape_name: str, mesh_name: str) -> str:
    os.makedirs(ART_DIR, exist_ok=True)
    return os.path.join(ART_DIR, f"{arch}__{shape_name}__{mesh_name}.json")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-cost", action="store_true",
                    help="memory only (multi-pod pass)")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    archs = all_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]

    failures = []
    for multi_pod in meshes:
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
        for arch in archs:
            for shape_name in shapes:
                path = cell_path(arch, shape_name, mesh_name)
                if os.path.exists(path) and not args.force:
                    print(f"[cached] {arch} x {shape_name} x {mesh_name}")
                    continue
                print(f"[run   ] {arch} x {shape_name} x {mesh_name} ...",
                      flush=True)
                try:
                    res = run_cell(arch, shape_name, multi_pod,
                                   with_cost=not args.no_cost)
                except Exception as e:  # record failures as data
                    res = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "status": "failed",
                           "error": f"{type(e).__name__}: {e}"[:2000],
                           "traceback": traceback.format_exc()[-2000:]}
                    failures.append((arch, shape_name, mesh_name))
                with open(path, "w") as f:
                    json.dump(res, f, indent=2)
                status = res["status"]
                extra = ""
                if status == "ok":
                    mem = res["memory"]["peak_estimate_bytes"] / 2**30
                    extra = (f" step={res['step_seconds']:.1f}s "
                             f"peak/device={mem:.2f}GiB")
                print(f"[{status:7s}] {arch} x {shape_name} x {mesh_name}"
                      f"{extra}", flush=True)
    if failures:
        print(f"\nFAILED cells: {failures}")
        raise SystemExit(1)
    print("\nall requested cells done")


if __name__ == "__main__":
    main()
