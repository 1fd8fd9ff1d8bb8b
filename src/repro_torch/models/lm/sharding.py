"""Sharding rules: map parameter/activation trees to named shardings, and
place trees on a device mesh as DTensors.

Counterpart of ``repro.models.lm.sharding``, with its rules and names.
Semantic TP rules (Megatron-style):

* column-parallel producing weights  — attention heads (wq on H, wk/wv on
  KV), FFN hidden (w_gate/w_up on F), experts (on E);
* row-parallel consuming weights     — wo (on H), w_down (on F / E);
* embeddings vocab-sharded (falls back to d_model when vocab doesn't
  divide the axis);
* SSM/RG-LRU channel dims (Di) model-sharded;
* norms/biases/scalars replicated.

When ``cfg.fsdp`` is set, the largest remaining divisible dim is
additionally sharded over the data axes (ZeRO-3-style parameter +
optimizer-state sharding).  Every emitted spec passes a divisibility
guard: an axis that does not divide its dim is dropped (replicated).
Stacked layer parameters (under ``segments``) keep their leading layer
dim unsharded.

The rules are pure functions of shapes and axis names.  A mesh is
anything whose ``shape`` maps axis names to sizes (as a JAX mesh's does)
or a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names``.  ``PartitionSpec`` is the port's counterpart of
``jax.sharding.PartitionSpec``: a tuple with one entry per tensor dim,
each ``None``, an axis name, or a tuple of axis names.  ``NamedSharding``
is a mesh plus a spec; its ``placements`` are the DTensor placements
that express it: ``Shard(d)`` on every mesh dim named for tensor dim
``d`` and ``Replicate()`` elsewhere.  ``distribute`` places a tree by
its shardings (the counterpart of ``jax.jit(in_shardings=...)``);
``place_local`` places a tree that every rank holds whole with no
collective (``place_batch``: a batch).  For the loops and the checkpoint,
``placement_of``, ``local_tensor`` and ``whole`` give a DTensor's
sharding, its local shard and its whole value (a plain tensor: None and
itself).

The activation hooks (``constrain``, ``constrain_tokens``, and the
port's ``constrain_cache``; the reference's ``constrain_moe_slots`` is
where each rank's MoE slots already lie, ``moe._sharded``)
redistribute a DTensor to the guarded placements while
``activation_mesh`` is active, the counterpart of
``with_sharding_constraint``; without an active mesh, or on a plain
tensor, they return their input untouched.  The rest is the port's own,
for what GSPMD does for the reference and DTensor does not, or not on
every PyTorch release: ``replicate_like`` (DTensor refuses to mix plain
tensors with DTensors), ``lookup_rows`` (data-dependent indexing, run
shard by shard with explicit gradient placements), ``matmul`` (every
product whose operands DTensor splits, each mesh axis's split chosen
here: DTensor's strategies, which differ between releases, choose none;
``gather_or_exchange`` decides whether an ``fsdp`` weight under a split
batch is gathered or kept split while the rows move, by ``all_to_all``
and the other functional collectives inside ``local_map``; it also
decides the MoE's ``fsdp`` experts, the SSM's in-projection and the
embedding lookup of an ``fsdp`` table; ``recording_lookups`` counts the
lookup's ways),
``write_slot`` (an
in-place write into a view across a split dim is silently lost),
``logsumexp``, ``take_last``, ``pad`` and ``stack``.  On plain tensors
each is the plain op.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import sys
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Sequence, Tuple

import torch

from ...configs.base import LMConfig
from ...tree import tree_map, tree_map_with_path


class PartitionSpec(tuple):
    """Per-dim sharding: ``None``, an axis name, or a tuple of axis names
    for each tensor dim (the port's ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size, in mesh order."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (the port's ``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        """The DTensor placements of ``spec`` on ``mesh``.  A tensor dim
        sharded over several axes is split over them in mesh order, which
        must be the order the spec lists them in.  An axis of size 1
        splits nothing and is ``Replicate()`` (so on a 1x1 mesh every
        DTensor holds the whole tensor and runs the unsharded ops)."""
        from torch.distributed.tensor import Replicate, Shard
        sizes = mesh_axes(self.mesh)
        names = list(sizes)
        out = [Replicate()] * len(names)
        for d, axes in enumerate(self.spec):
            if axes is None:
                continue
            ax = (axes,) if isinstance(axes, str) else tuple(axes)
            idx = [names.index(a) for a in ax]
            if idx != sorted(idx):
                raise ValueError(f"spec {self.spec}: axes {ax} of dim {d} are "
                                 f"not in mesh order {names}")
            for i in idx:
                if sizes[names[i]] > 1:
                    out[i] = Shard(d)
        return tuple(out)


def _path_names(path) -> list:
    out = []
    for k in path:
        if hasattr(k, "key"):
            out.append(str(k.key))
        elif hasattr(k, "name"):
            out.append(str(k.name))
        elif hasattr(k, "idx"):
            out.append(str(k.idx))
        else:
            out.append(str(k))
    return out


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    shape = mesh_axes(mesh)
    if isinstance(axes, str):
        return shape[axes]
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def _guard(mesh, shape: Tuple[int, ...], spec: Sequence) -> PartitionSpec:
    """Drop axes that don't divide their dim."""
    sizes = mesh_axes(mesh)
    fixed = []
    for dim, axes in zip(shape, spec):
        if axes is None:
            fixed.append(None)
            continue
        ax = (axes,) if isinstance(axes, str) else tuple(axes)
        keep = []
        size = dim
        for a in ax:
            s = sizes[a]
            if size % s == 0:
                keep.append(a)
                size //= s
        fixed.append(tuple(keep) if len(keep) > 1 else
                     (keep[0] if keep else None))
    return P(*fixed)


def _with_fsdp(spec: list, shape: Tuple[int, ...], mesh, dp_axes,
               enabled: bool) -> list:
    """Shard the largest still-unsharded divisible dim over data axes."""
    if not enabled:
        return spec
    dp = _axis_size(mesh, dp_axes)
    best, best_dim = None, 0
    for i, (dim, axes) in enumerate(zip(shape, spec)):
        if axes is None and dim % dp == 0 and dim > best_dim:
            best, best_dim = i, dim
    if best is not None:
        spec = list(spec)
        spec[best] = dp_axes
    return spec


def dp_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)


def param_pspec(cfg: LMConfig, mesh, path, leaf) -> PartitionSpec:
    names = _path_names(path)
    name = names[-1]
    stacked = any(n in ("segments", "enc_segments") for n in names)
    dp = dp_axes(mesh)
    shape = tuple(leaf.shape)
    core = shape[1:] if stacked else shape
    m = "model"

    def build(spec_core: list, fsdp_dims: bool = True) -> PartitionSpec:
        spec_core = _with_fsdp(spec_core, core, mesh, dp,
                               cfg.fsdp and fsdp_dims)
        spec = ([None] + list(spec_core)) if stacked else list(spec_core)
        return _guard(mesh, shape, spec)

    # ---- embeddings / heads -------------------------------------------
    if name == "embed":                       # (V, D)
        if shape[0] % _axis_size(mesh, m) == 0:
            return build([m, None])
        return build([None, m])
    if name == "lm_head":                     # (D, V)
        if shape[-1] % _axis_size(mesh, m) == 0:
            return build([None, m])
        return build([m, None])

    # ---- attention ------------------------------------------------------
    if name == "wq":                          # (D, H, hd)
        return build([None, m, None])
    if name in ("wk", "wv"):                  # (D, KV, hd)
        return build([None, m, None])
    if name == "wo":                          # (H, hd, D)
        return build([m, None, None])

    # ---- dense FFN ------------------------------------------------------
    if name in ("w_gate", "w_up"):
        if len(core) == 3:                    # MoE (E, D, F)
            if core[0] % _axis_size(mesh, m) == 0:
                return build([m, None, None])
            return build([None, None, m])
        return build([None, m])               # (D, F)
    if name == "w_down":
        if len(core) == 3:                    # MoE (E, F, D)
            if core[0] % _axis_size(mesh, m) == 0:
                return build([m, None, None])
            return build([None, m, None])
        return build([m, None])               # (F, D)
    if name in ("w_in", "b_in"):              # plain MLP (D, F)/(F,)
        if len(core) == 2:
            return build([None, m])
        return build([m])
    if name in ("w_out", "b_out"):
        if name == "w_out" and len(core) == 2:
            return build([m, None])           # (F|Di, D)
        return build([None] * len(core), fsdp_dims=False)
    if name == "w_router":                    # (D, E) — replicated, f32
        return build([None, None], fsdp_dims=False)

    # ---- SSM / RG-LRU ---------------------------------------------------
    if name in ("conv_w",):                   # (K, Di)
        return build([None, m])
    if name in ("conv_b", "dt_bias", "d_skip", "lam"):
        return build([m])
    if name in ("w_dt_down", "w_bc", "a_log", "w_r", "w_i"):  # (Di, *)
        return build([m, None])
    if name == "w_dt_up":                     # (R, Di)
        return build([None, m])
    if name in ("w_x", "w_y"):                # (D, Di)
        return build([None, m])

    # ---- norms & everything else: replicated -----------------------------
    return build([None] * len(core), fsdp_dims=False)


def param_shardings(cfg: LMConfig, mesh, abstract_params):
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, param_pspec(cfg, mesh, path,
                                                           leaf)),
        abstract_params)


# ---------------------------------------------------------------------------
# activations / batches / caches
# ---------------------------------------------------------------------------

def batch_pspec(mesh, shape: Tuple[int, ...]) -> PartitionSpec:
    dp = dp_axes(mesh)
    return _guard(mesh, shape, [dp] + [None] * (len(shape) - 1))


def batch_shardings(mesh, batch_spec: Dict[str, Any]):
    return {k: NamedSharding(mesh, batch_pspec(mesh, tuple(v.shape)))
            for k, v in batch_spec.items()}


def cache_pspec(mesh, path, leaf) -> PartitionSpec:
    """Stacked cache entries (L, B, S, KV, hd) / states (L, B, ...).

    Preference: batch over data axes; KV heads over model; if KV doesn't
    divide, shard the sequence dim over model (decode attention reduces
    over S with collectives); long-context batch-1 shapes shard S over
    both data and model.
    """
    dp = dp_axes(mesh)
    sizes = mesh_axes(mesh)
    shape = tuple(leaf.shape)
    if len(shape) == 5:                     # KV cache (L,B,S,KV,hd)
        L, B, S, KV, hd = shape
        spec: list = [None, dp, None, "model", None]
        if KV % sizes["model"] != 0:
            spec[3] = None
            spec[2] = "model"
        if B < _axis_size(mesh, dp):
            spec[1] = None
            # push data axes onto sequence as well
            cur = spec[2]
            if cur is None:
                spec[2] = dp
            else:
                spec[2] = tuple(list(dp) + [cur])
        return _guard(mesh, shape, spec)
    if len(shape) >= 2:                     # states (L,B,...) / (L,B,Di,N)
        spec = [None, dp] + [None] * (len(shape) - 2)
        if len(shape) >= 3 and shape[1] < _axis_size(mesh, dp):
            spec[1] = None
            spec[2] = "model" if shape[2] % sizes["model"] == 0 else None
        return _guard(mesh, shape, spec)
    return P()


def cache_shardings(mesh, abstract_cache):
    """Shardings of a ``ServeCache`` (or its ``init_cache_spec``): the
    position counter is replicated."""
    def rule(path, leaf):
        if not hasattr(leaf, "shape") or tuple(leaf.shape) == ():
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, cache_pspec(mesh, path, leaf))
    return tree_map_with_path(rule, abstract_cache)


def opt_shardings(cfg: LMConfig, mesh, abstract_opt, abstract_params):
    """m/v mirror the param shardings; step replicated."""
    from ...optim.adamw import AdamWState
    pshard = param_shardings(cfg, mesh, abstract_params)
    return AdamWState(step=NamedSharding(mesh, P()), m=pshard,
                      v=tree_map(lambda s: s, pshard))


def replicated(mesh):
    return NamedSharding(mesh, P())


def distribute(tree, shardings):
    """Place every tensor of ``tree`` by the matching ``NamedSharding`` of
    ``shardings`` (a tree of the same structure): a plain tensor with
    ``distribute_tensor``, a DTensor (a cache a sharded prefill returned)
    by redistributing it; non-tensor leaves (a Python int position)
    pass through."""
    from torch.distributed.tensor import distribute_tensor

    def put(t, s):
        if not isinstance(t, torch.Tensor):
            return t
        if _is_dtensor(t):
            return t.redistribute(s.mesh, s.placements)
        return distribute_tensor(t, s.mesh, s.placements)
    return tree_map(put, tree, shardings)


# ---------------------------------------------------------------------------
# activation-constraint context (set by launchers; no-op without a mesh)
# ---------------------------------------------------------------------------

_ACT_MESH: "contextvars.ContextVar" = contextvars.ContextVar(
    "repro_torch_activation_mesh", default=None)


@contextlib.contextmanager
def activation_mesh(mesh):
    """While active, ``constrain`` pins activation shardings to ``mesh``
    (a ``DeviceMesh``).  Launchers (the dry run, sharded serving and
    training) wrap the step in this; tests and single-device runs skip it
    and ``constrain`` is a no-op."""
    tok = _ACT_MESH.set(mesh)
    try:
        yield
    finally:
        _ACT_MESH.reset(tok)


def _is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor, without importing DTensor (a heavy
    import) in a process that has made none."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def placement_of(t):
    """``(mesh, placements)`` of DTensor ``t``; None for a plain tensor.
    What a key of jit's cache holds of an input beside its shape and
    dtype: its sharding."""
    if not _is_dtensor(t):
        return None
    return t.device_mesh, tuple(t.placements)


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """The shard of DTensor ``t`` that this rank holds, a view (writing
    into it writes ``t``); a plain tensor itself."""
    return t.to_local() if _is_dtensor(t) else t


def whole(t: torch.Tensor) -> torch.Tensor:
    """DTensor ``t`` gathered whole on every rank (``full_tensor``), as the
    reference's ``jax.device_get`` gathers an array; a plain tensor
    itself."""
    return t.full_tensor() if _is_dtensor(t) else t


def place_local(tree, shardings):
    """``distribute(tree, shardings)`` for a tree that every rank holds
    whole and the same (made from one seed, one step counter, the same
    prompts or one checkpoint): each rank keeps its own shard of its own
    copy and no collective runs, so placing it leaves no collective in
    flight when a captured step follows."""
    from torch.distributed.tensor import distribute_tensor

    def put(t, s):
        if not isinstance(t, torch.Tensor):
            return t
        return distribute_tensor(t, s.mesh, s.placements, src_data_rank=None)
    return tree_map(put, tree, shardings)


def place_batch(mesh, batch: Dict[str, torch.Tensor]):
    """``batch`` placed by ``batch_shardings`` with ``place_local``."""
    return place_local(batch, batch_shardings(mesh, batch))


def splits_dim(x, dim: int) -> bool:
    """Whether DTensor ``x`` splits tensor dim ``dim`` over a mesh axis."""
    if not _is_dtensor(x):
        return False
    from torch.distributed.tensor import Shard
    return any(isinstance(p, Shard) and p.dim == dim for p in x.placements)


def splits_any(x) -> bool:
    """Whether DTensor ``x`` splits any dim over a mesh axis."""
    if not _is_dtensor(x):
        return False
    from torch.distributed.tensor import Shard
    return any(isinstance(p, Shard) for p in x.placements)


def to_spec(x, spec: Sequence):
    """DTensor ``x`` redistributed to ``spec`` (one entry per dim, guarded
    by ``_guard``) on its own mesh."""
    mesh = x.device_mesh
    guarded = _guard(mesh, tuple(x.shape), spec)
    return x.redistribute(mesh, NamedSharding(mesh, guarded).placements)


def constrain(x, spec_fn):
    """Redistribute DTensor ``x`` to ``spec_fn(mesh, dp)`` (a list with one
    entry per dim; axes that don't divide are dropped by ``_guard``) if an
    activation mesh is active; otherwise return ``x``."""
    mesh = _ACT_MESH.get()
    if mesh is None or x is None or not _is_dtensor(x):
        return x
    return to_spec(x, spec_fn(mesh, dp_axes(mesh)))


def constrain_tokens(x):
    """Residual stream (B, S, D): batch over data axes."""
    return constrain(x, lambda mesh, dp: [dp] + [None] * (x.ndim - 1))


def constrain_cache(x):
    """A layer's KV cache (B, S_max, KV, hd) placed by ``cache_pspec`` as
    it is made, so a prefill never holds more of the cache than its
    shard (GSPMD propagates the reference's cache ``out_shardings`` back
    into its prefill the same way)."""
    from types import SimpleNamespace
    leaf = SimpleNamespace(shape=(1,) + tuple(x.shape))
    return constrain(x, lambda mesh, dp: list(cache_pspec(mesh, (), leaf))[1:])


def replicate_like(t: torch.Tensor, ref) -> torch.Tensor:
    """``t`` (a plain tensor built inside a block: rope tables, masks,
    positions) as a replicated DTensor on ``ref``'s mesh when ``ref`` is a
    DTensor; otherwise ``t`` itself."""
    if not _is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _local_bytes(shape, placements, mesh, itemsize: int) -> int:
    """Bytes of one rank's shard of a tensor of ``shape`` placed by
    ``placements`` on ``mesh`` (even shards; a placement of a dim past
    ``shape`` is ignored, so a prefix of a shape counts its own dims)."""
    from torch.distributed.tensor import Shard
    dims = list(shape)
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard) and pl.dim < len(dims):
            dims[pl.dim] //= mesh.size(i)
    n = itemsize
    for d in dims:
        n *= d
    return n


def all_to_all(t: torch.Tensor, group, n: int, split_dim: int,
               cat_dim: int) -> torch.Tensor:
    """Inside ``local_map``: chunk p of ``t`` along ``split_dim`` (``n``
    equal chunks) goes to rank p of ``group`` (a ``(mesh, mesh dim)``
    pair of ``n`` ranks); the chunks this rank receives are concatenated
    along ``cat_dim`` (a dim of ``t``, counted from 0) in rank order.
    Differentiable: the backward is the opposite exchange."""
    from torch.distributed import _functional_collectives as funcol
    parts = t.unflatten(split_dim, (n, -1)).movedim(split_dim, 0)
    got = funcol.all_to_all_single_autograd(parts.contiguous(), None, None,
                                            group)
    return got.movedim(0, cat_dim).flatten(cat_dim, cat_dim + 1)


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Inside ``local_map``: ``t`` gathered from every rank of ``group``
    along ``dim`` (differentiable; the backward reduce-scatters)."""
    from torch.distributed import _functional_collectives as funcol
    gather = getattr(funcol, "all_gather_single_autograd", None) \
        or funcol.all_gather_tensor_autograd
    return gather(t.contiguous(), dim, group)


def _reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Inside ``local_map``: ``t`` summed over the ranks of ``group`` and
    split along ``dim``, this rank keeping its chunk (differentiable; the
    backward all-gathers)."""
    from torch.distributed import _functional_collectives as funcol
    scatter = getattr(funcol, "reduce_scatter_single_autograd", None) \
        or funcol.reduce_scatter_tensor_autograd
    out = scatter(t.contiguous(), "sum", dim, group)
    # a copy once it has landed: a pending result (an
    # ``AsyncCollectiveTensor``) leaving ``local_map`` drops the gradient
    # of the ops that DTensor later runs on it
    return out.clone() if isinstance(out, funcol.AsyncCollectiveTensor) \
        else out


def gather_or_exchange(gather: int, exchange: int) -> str:
    """How a product meets a weight split over a mesh axis where its rows
    cannot simply be contracted against the local slice (an ``fsdp``
    weight under a batch split over the same axis: ``matmul``, the MoE's
    experts, ``lookup_rows``; the SSM's in-projection), from the bytes
    each way moves a rank a call (sent or received, in the forward; each
    way's backward mirrors it), which the caller counts for its shapes:
    ``"gather"`` (gather the weight; for ``fsdp``, reduce-scatter its
    gradient back) where that moves strictly fewer bytes, else
    ``"exchange"`` (keep the weight split and move the rows).  The one
    rule for every such choice."""
    return "gather" if gather < exchange else "exchange"


def matmul_bytes(x_bytes: int, w_bytes: int, y_bytes: int, n: int,
                 w_dim: int) -> Tuple[int, int]:
    """(gather, exchange): the bytes a rank moves a call in ``matmul``'s two
    ways over a mesh axis of ``n`` ranks that splits the batch of x
    (``x_bytes`` on a rank) and dim ``w_dim`` of w (``w_bytes``), the
    product ``y_bytes`` on a rank.  The gather receives n - 1 shards of
    w.  The exchange, where w's contracted dim (``w_dim`` 0) is split,
    sends (n - 1) / n of x's rows for a slice of every rank's rows and
    reduce-scatters the partial product back over the batch (n - 1 times
    a rank's share); where an output dim is split, it gathers every
    rank's rows and exchanges the output's column slices back for
    rows."""
    if w_dim == 0:
        exchange = (n - 1) * x_bytes // n + (n - 1) * y_bytes
    else:
        exchange = (n - 1) * x_bytes + (n - 1) * y_bytes // n
    return (n - 1) * w_bytes, exchange


def matmul(x: torch.Tensor, w: torch.Tensor, local=None) -> torch.Tensor:
    """``x @ w``, x (B, ..., K) and w (K, N); or ``local(x, w)`` for a w
    with several output dims (K, N1, N2, ...), whose product is (B, ...,
    N1, N2, ...) (the attention projections).  DTensors run it shard by
    shard, with each mesh axis's split chosen here, never by DTensor's
    strategies (which differ between PyTorch releases):

    * an axis that splits x's batch and not w: the product is split by
      batch, w's gradient a partial sum;
    * an axis that splits w's K and not the batch: x is sliced along K to
      match and the product is a partial sum (the row-parallel product,
      and an ``fsdp`` weight at batch 1, as GSPMD keeps it);
    * an axis that splits an output dim of w and not the batch: the
      product is split along that dim (column-parallel), x's gradient a
      partial sum;
    * an axis that splits both the batch and w (an ``fsdp`` weight under a
      data-split batch): ``gather_or_exchange`` picks the way that moves
      fewer bytes a rank (``matmul_bytes``).  At decode a rank's rows are
      few and the rows move (the weight stays split); at training the
      weight is gathered.  With more than one such axis (the multi-pod
      mesh) the weight is gathered.

    The partial sums are left for the next op to reduce, as DTensor's own
    product leaves them."""
    return matmuls(x, (w,), local)[0]


def matmuls(x: torch.Tensor, ws: Sequence[torch.Tensor], local=None) -> list:
    """``[matmul(x, w, local) for w in ws]``, x read once: under a mesh x
    is placed once for every product that takes it in the same placement
    (q, k and v; gate and up), so the partial sums of its gradient from
    each are added up before one reduction, where placing it for each
    would reduce each apart."""
    if local is None:
        local = torch.matmul
    if not (splits_any(x) or any(splits_any(w) for w in ws)):
        return [local(x, w) for w in ws]
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    placed = {}
    out = []
    for w in ws:
        x_pl, w_pl, y_pl, gx, gw, ex = _product_plan(x, w)
        if x_pl not in placed:
            placed[x_pl] = x.redistribute(mesh, x_pl)
        y, = local_map(functools.partial(_product, local, ex),
                       out_placements=(y_pl,), in_placements=(x_pl, w_pl),
                       in_grad_placements=(gx, gw), device_mesh=mesh)(
            placed[x_pl], w.redistribute(mesh, w_pl))
        out.append(y)
    return out


def _product_plan(x, w):
    """``matmul``'s placements of x, w, the product and x's and w's
    gradients, one entry a mesh axis, and its exchange (None, or the
    group, size and w's split dim of the axis whose rows move)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    last = x.ndim - 1
    both = [i for i, (xp, wp) in enumerate(zip(x.placements, w.placements))
            if xp == Shard(0) and isinstance(wp, Shard)]
    rules = []
    for i, (xp, wp) in enumerate(zip(x.placements, w.placements)):
        if i in both:
            rules.append((xp, wp, Shard(0), Shard(0), wp))
        elif xp == Shard(0):
            rules.append((xp, Replicate(), Shard(0), Shard(0), Partial()))
        elif wp == Shard(0):
            rules.append((Shard(last), wp, Partial(), Shard(last), wp))
        elif isinstance(wp, Shard):
            rules.append((Replicate(), wp, Shard(last + wp.dim - 1),
                          Partial(), wp))
        else:
            rules.append((Replicate(),) * 5)
    x_pl, w_pl, y_pl, gx, gw = (list(r) for r in zip(*rules))
    ex = None
    if len(both) == 1:
        i = both[0]
        n, w_dim = mesh.size(i), w.placements[i].dim
        y_shape = tuple(x.shape[:-1]) + tuple(w.shape[1:])
        itemsize = torch.promote_types(x.dtype, w.dtype).itemsize
        if gather_or_exchange(*matmul_bytes(
                _local_bytes(x.shape, x_pl, mesh, x.element_size()),
                _local_bytes(w.shape, w_pl, mesh, w.element_size()),
                _local_bytes(y_shape, y_pl, mesh, itemsize), n,
                w_dim)) == "exchange":
            ex = ((mesh, i), n, w_dim)
    if ex is None:
        for i in both:
            w_pl[i], gw[i] = Replicate(), Partial()
    return (tuple(x_pl), tuple(w_pl), tuple(y_pl), tuple(gx), tuple(gw),
            ex)


def _product(local, ex, x, w):
    """One rank's ``local(x, w)`` for ``matmul``, with its exchange: where
    w's K is split, x's rows for a slice of K and the partial products
    of every rank's rows summed and split back by rows; where an output
    dim is split, every rank's rows and the output's column slices
    exchanged back for rows."""
    if ex is None:
        return (local(x, w),)
    group, n, w_dim = ex
    if w_dim == 0:
        x = all_to_all(x, group, n, x.ndim - 1, 0)
        return (_reduce_scatter(local(x, w), group, 0),)
    y = local(_all_gather(x, group, 0), w)
    return (all_to_all(y, group, n, 0, x.ndim - 2 + w_dim),)


def microbatch_rows(x: torch.Tensor, i: int, mb: int) -> torch.Tensor:
    """Microbatch ``i`` of ``mb`` rows of the batch ``x`` (batch first):
    ``x[i * mb:(i + 1) * mb]`` on a plain tensor.  A DTensor split along
    its batch over n ranks (n dividing ``mb``) takes rows ``[i * mb / n,
    (i + 1) * mb / n)`` of each rank's shard, so no rank gathers the batch
    (slicing the global rows would); the microbatches hold other rows than
    the plain slices, each row in exactly one, so the summed gradient and
    the mean loss are the same sums in another order."""
    if not splits_dim(x, 0):
        return x[i * mb:(i + 1) * mb]
    from torch.distributed.tensor import DTensor, Shard
    mesh = x.device_mesh
    n = 1
    for d, pl in enumerate(x.placements):
        if pl == Shard(0):
            n *= mesh.size(d)
    if mb % n or x.shape[0] % n:
        return x[i * mb:(i + 1) * mb]
    local = x.to_local()
    rows = mb // n
    part = local[i * rows:(i + 1) * rows]
    return DTensor.from_local(part, mesh, x.placements, run_check=False,
                              shape=torch.Size((mb,) + tuple(x.shape[1:])),
                              stride=_contiguous((mb,) + tuple(x.shape[1:])))


def _contiguous(shape) -> tuple:
    """Strides of a contiguous tensor of ``shape``."""
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return tuple(stride)


_LOOKUP_WAYS: "contextvars.ContextVar" = contextvars.ContextVar(
    "repro_torch_lookup_ways", default=None)


@contextlib.contextmanager
def recording_lookups():
    """Yields a ``collections.Counter`` that counts, while active, the way
    each ``lookup_rows`` call met a table split along D over a data axis:
    ``"gather"`` or ``"exchange"`` under a batch split over that axis
    (``gather_or_exchange``'s choice), ``"split"`` at a batch it does not
    split (batch 1)."""
    ways = collections.Counter()
    tok = _LOOKUP_WAYS.set(ways)
    try:
        yield ways
    finally:
        _LOOKUP_WAYS.reset(tok)


def _note_lookup(way: str) -> None:
    ways = _LOOKUP_WAYS.get()
    if ways is not None:
        ways[way] += 1


def lookup_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: an embedding lookup, idx (B, ...) -> (B, ..., D).
    DTensors run it shard by shard: ``idx`` split over the data axes; the
    table kept split along its rows (the vocabulary) over ``model`` where
    the rules split it so, else whole along its rows and split along D
    over ``model`` where D divides.  A rank holding a slice of the rows
    looks up the ids that fall in it, writes zeros for the rest, and the
    partial rows are summed over ``model`` (the vocab-parallel lookup
    GSPMD makes of the reference's ``embed[tokens]``: no rank gathers the
    table).  A table split along D over a data axis (an ``fsdp`` table):

    * at a batch that axis does not split (batch 1) it stays split: each
      rank looks up its slice of D, and the rows are gathered along D;
    * under a batch split over that axis, ``gather_or_exchange`` picks by
      the bytes a rank moves (``matmul_bytes``: the lookup is a product by
      one-hot rows whose output dim D is split): gather the table (its
      gradient a partial sum over the axis), or keep it split and
      exchange: every rank's ids are gathered, each rank looks up its
      slice of D for all of them, and one all-to-all returns each rank
      its own rows whole along D; the backward sends the rows' gradients
      back the same way and scatter-adds them into the local slice, so
      the table's gradient stays split.  With more than one such axis
      (the multi-pod mesh), or D split over ``model`` too, the table is
      gathered.

    The table's gradient is otherwise split as the table is, and a partial
    sum over the axes that split ``idx``.  (DTensor's own strategies for
    this lookup, the vocab-parallel mask and ``index_put`` in the
    backward, fail on some PyTorch releases.)"""
    if not _is_dtensor(idx):
        return table[idx]
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = idx.device_mesh
    idx = to_spec(idx, [dp_axes(mesh)] + [None] * (idx.ndim - 1))
    by_rows = splits_dim(table, 0)
    names = mesh.mesh_dim_names
    t_pl = []
    for i, (name, tp) in enumerate(zip(names, table.placements)):
        if name == "model":
            t_pl.append(Shard(0) if by_rows else Shard(1)
                        if mesh.size(i) > 1 and table.shape[1] % mesh.size(i)
                        == 0 else Replicate())
        else:
            t_pl.append(tp if tp == Shard(1) else Replicate())
    d_split = [i for i, pl in enumerate(t_pl) if pl == Shard(1)]
    both = [i for i in d_split if isinstance(idx.placements[i], Shard)]
    ex = None
    if both:
        way = "gather"
        if d_split == both and len(both) == 1:
            n = mesh.size(both[0])
            n_ids = _local_bytes(idx.shape, idx.placements, mesh, 1)
            way = gather_or_exchange(*matmul_bytes(
                n_ids * idx.element_size(),
                _local_bytes(table.shape, t_pl, mesh, table.element_size()),
                n_ids * table.shape[1] * table.element_size(), n, 1))
        if way == "exchange":
            ex = ((mesh, both[0]), n)
        else:
            for i in both:
                t_pl[i] = Replicate()
        _note_lookup(way)
    elif any(names[i] != "model" for i in d_split):
        _note_lookup("split")
    table = table.redistribute(mesh, tuple(t_pl))
    lo = _local_offset(table, 0)
    out, grad = [], []
    for ip, tp in zip(idx.placements, table.placements):
        if isinstance(ip, Shard):
            out.append(Shard(0))
            grad.append(tp if isinstance(tp, Shard) else Partial())
        elif isinstance(tp, Shard):
            out.append(Partial() if tp.dim == 0 else Shard(idx.ndim))
            grad.append(tp)
        else:
            out.append(Replicate())
            grad.append(Replicate())

    def local(t, i):
        if ex is not None:
            group, n = ex
            gather = getattr(funcol, "all_gather_single", None) \
                or funcol.all_gather_tensor
            i = gather(i.contiguous(), 0, group)
        if by_rows:
            inside = (i >= lo) & (i < lo + t.shape[0])
            rows = t[torch.where(inside, i - lo, 0)]
            rows = torch.where(inside[..., None], rows, torch.zeros(
                (), dtype=rows.dtype, device=rows.device))
        else:
            rows = t[i]
        if ex is not None:
            rows = all_to_all(rows, group, n, 0, rows.ndim - 1)
        return (rows,)

    rows, = local_map(local, out_placements=(tuple(out),),
                      in_placements=(table.placements, idx.placements),
                      in_grad_placements=(tuple(grad), idx.placements),
                      device_mesh=mesh)(table, idx)
    return rows.redistribute(mesh, tuple(
        pl if isinstance(pl, Shard) and name == "model" or pl == Shard(0)
        else Replicate() for name, pl in zip(names, out)))


def pad(x: torch.Tensor, widths: Sequence[int]) -> torch.Tensor:
    """``F.pad(x, widths)`` (zeros).  A DTensor is padded shard by shard,
    so the padded dims must not be split (a sequence or a head count;
    DTensor's own pad fails on some PyTorch releases)."""
    import torch.nn.functional as F
    if not _is_dtensor(x):
        return F.pad(x, widths)
    from torch.distributed.tensor.experimental import local_map
    padded = [x.ndim - 1 - i // 2 for i, w in enumerate(widths) if w]
    if any(splits_dim(x, d) for d in padded):
        raise ValueError(f"pad: dims {padded} of {x.placements} are split")
    out, = local_map(lambda t: (F.pad(t, widths),),
                     out_placements=(x.placements,),
                     in_placements=(x.placements,),
                     device_mesh=x.device_mesh)(x)
    return out


def stack(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``torch.stack(xs)``.  DTensors of one placement (a segment's
    per-layer caches) are stacked shard by shard, the new leading dim
    whole: DTensor's own stack strategy fails on some PyTorch releases."""
    if not _is_dtensor(xs[0]):
        return torch.stack(xs)
    from torch.distributed.tensor import DTensor, Shard
    pl = xs[0].placements
    if any(x.placements != pl for x in xs):
        raise ValueError(f"stack: placements differ: "
                         f"{[x.placements for x in xs]}")
    local = torch.stack([x.to_local() for x in xs])
    shape = (len(xs),) + tuple(xs[0].shape)
    return DTensor.from_local(
        local, xs[0].device_mesh,
        [Shard(p.dim + 1) if isinstance(p, Shard) else p for p in pl],
        run_check=False, shape=torch.Size(shape), stride=_contiguous(shape))


def _local_offset(t, dim: int) -> int:
    """Global index of the first element along ``dim`` of this rank's
    shard of DTensor ``t`` (even shards, split in mesh-dim order)."""
    from torch.distributed.tensor import Shard
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    size, off = t.shape[dim], 0
    for i, pl in enumerate(t.placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            size //= mesh.size(i)
            off += coord[i] * size
    return off


def write_slot(dst: torch.Tensor, src: torch.Tensor, dim: int,
               index: torch.Tensor) -> None:
    """``dst.narrow(dim, index, 1).copy_(src)``, in place, for ``index`` a
    () integer tensor in range, never read on the host: an indexed copy
    (into each rank's shard of a DTensor whose ``dim`` is whole).
    Also when ``dst`` is a DTensor sharded along ``dim`` (a KV cache whose
    sequence is split over the model axis): each rank writes its own
    shard where ``index`` falls in it, and writes back the slot it holds
    elsewhere, the choice made on the device."""
    if not _is_dtensor(dst):
        dst.index_copy_(dim, index.reshape(1).long(), src)
        return
    from torch.distributed.tensor import Replicate, Shard
    src_pl = tuple(Replicate() if isinstance(pl, Shard) and pl.dim == dim
                   else pl for pl in dst.placements)
    local = dst.to_local()
    new = src.redistribute(dst.device_mesh, src_pl).to_local()
    if not splits_dim(dst, dim):
        # every rank holds all of ``dim``: the plain indexed copy, with no
        # kernels spent on choosing the slot (a decode step writes 2 a
        # layer)
        local.index_copy_(dim, index.reshape(1).long(), new)
        return
    n = local.shape[dim]
    at = index.long() - _local_offset(dst, dim)
    held = (at >= 0) & (at < n)
    at = at.clamp(0, n - 1)
    # the slot's value: a gather of one position broadcast to its shape
    old = torch.gather(local, dim,
                       at.reshape((1,) * local.ndim).expand(new.shape))
    local.index_copy_(dim, at.reshape(1), torch.where(held, new, old))


def _last_dim_split(x):
    """DTensor ``x`` with its partial sums reduced, the mesh dims that split
    its last dim, its placements with those dims whole, and with those
    dims a partial sum."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if any(isinstance(pl, Partial) for pl in x.placements):
        x = x.redistribute(x.device_mesh, tuple(
            Replicate() if isinstance(pl, Partial) else pl
            for pl in x.placements))
    split = [i for i, pl in enumerate(x.placements)
             if isinstance(pl, Shard) and pl.dim == x.ndim - 1]
    whole = tuple(Replicate() if i in split else pl
                  for i, pl in enumerate(x.placements))
    partial = tuple(Partial() if i in split else pl
                    for i, pl in enumerate(whole))
    return x, split, whole, partial


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp(x, dim=-1)``.  On a DTensor whose last dim (the
    vocabulary) is split over mesh axes, each rank takes the max and the
    sum of exponentials over its own slice, the max all-reduced first (no
    gradient flows through it) and the sums added as a partial sum, as
    GSPMD reduces the reference's: DTensor's own strategies for the fused
    op, and for ``x - max`` broadcast over a split dim, move the operand
    to another split, which gathers it."""
    if not _is_dtensor(x):
        return torch.logsumexp(x, dim=-1)
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    x, split, whole, partial = _last_dim_split(x)

    def local(t):
        m = t.detach().amax(-1)
        for i in split:
            m = funcol.all_reduce(m, "max", (mesh, i))
        return torch.exp(t - m[..., None]).sum(-1), m

    s, m = local_map(local, out_placements=(partial, whole),
                     in_placements=(x.placements,), device_mesh=mesh)(x)
    return torch.log(s.redistribute(mesh, whole)) + m


def take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``torch.gather(x, -1, idx[..., None])[..., 0]``.  On a DTensor whose
    last dim (the vocabulary) is split over mesh axes, each rank picks the
    entries that fall in its own slice and zeros elsewhere, and the
    partial picks are summed: exactly one term of the sum is nonzero, so
    the value is the same, and no rank builds a full-vocabulary mask or
    gradient."""
    if not _is_dtensor(x):
        return torch.gather(x, -1, idx[..., None].long())[..., 0]
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    x, _, whole, partial = _last_dim_split(x)
    lo = _local_offset(x, x.ndim - 1)

    def local(t, i):
        j = i.long() - lo
        inside = (j >= 0) & (j < t.shape[-1])
        got = torch.gather(t, -1, j.clamp(0, t.shape[-1] - 1)[..., None])
        return (torch.where(inside, got[..., 0], torch.zeros(
            (), dtype=got.dtype, device=got.device)),)

    out, = local_map(local, out_placements=(partial,),
                     in_placements=(x.placements, whole),
                     device_mesh=mesh)(x, idx.redistribute(mesh, whole))
    return out.redistribute(mesh, whole)
