"""Checkpointed, failure-tolerant training loop.

Counterpart of ``repro.runtime.train_loop``, with its fault-tolerance
contract:

* **checkpoint/restart** — atomic checkpoints every ``ckpt_every`` steps
  (``repro_torch.checkpoint``, the reference's on-disk layout); on start
  the loop resumes from the newest committed step, and the counter-based
  data pipeline replays the exact stream.
* **step retry** — a step that raises is retried up to ``max_retries``
  times; persistent failure saves a checkpoint before re-raising (so a
  supervisor restart continues cleanly).
* **NaN circuit-breaker** — a non-finite loss rolls back to the last
  checkpoint and skips the offending data step (recorded in the report).

The loop runs on ``device`` (the card unless the caller asks for the
CPU); initial parameters are drawn from ``torch.Generator(device)``
seeded 0.  With a ``mesh`` (a ``DeviceMesh`` over ``device``), as the
reference's loop takes one, the parameters and AdamW state are placed by
``sharding.param_shardings`` and ``opt_shardings``, each batch by
``batch_shardings``, and the step is ``model.make_train_step(cfg, tcfg,
mesh=mesh)`` under ``sharding.activation_mesh``; checkpoints hold the
whole tree (``ckpt``), and a resume or a rollback places it again.

The reference compiles its train step with ``jax.jit``.  The port's
counterpart on the card is ``GraphedTrainStep``: the step captured into
one CUDA graph for the run's fixed shapes and replayed every step.  The
graph writes the new parameters and optimizer state over its static
buffers as its last work, so the step on the card is not functional; the
loop still never sees half-updated state.  A fault before the replay
leaves the state as it was (retry; a persistent fault saves it), a
replay failure (``serve_loop.GraphError``) ends the run with no save, and
a non-finite loss restores the newest checkpoint, which the next call
copies into the static buffers.  Under a mesh the graph is captured over
sharded state as over whole state.  On the CPU (a gloo mesh included) the
loop runs the plain step.
"""

from __future__ import annotations

import math
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from ..checkpoint import ckpt
from ..configs.base import LMConfig, ShapeSpec
from ..data.pipeline import DataConfig, DataIterator
from ..models.lm import model, sharding, transformer
from ..optim import adamw
from ..tree import tree_flatten_with_names, tree_leaves, tree_map
from .serve_loop import GraphError, _copy_into, _leaf_key


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = field(default_factory=_default_ckpt_dir)
    ckpt_keep: int = 3
    max_retries: int = 2
    log_every: int = 10
    opt: adamw.AdamWConfig = field(default_factory=adamw.AdamWConfig)


@dataclass
class TrainReport:
    steps_run: int
    final_step: int
    resumed_from: Optional[int]
    losses: List[float]
    retries: int
    rollbacks: int
    wall_seconds: float
    capture_seconds: List[float] = field(default_factory=list)


def step_and_commit(step: Callable, params, opt_state: adamw.AdamWState,
                    batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The program a ``GraphedTrainStep`` captures: ``step(params,
    opt_state, batch)``, then the new parameters and optimizer state
    written over ``params`` and ``opt_state``; returns the step's metrics.
    Every new leaf is computed before the first write, so no part of the
    update reads a leaf already overwritten; a sharded leaf is written
    shard by shard (``serve_loop._copy_into``)."""
    new_params, new_opt, metrics = step(params, opt_state, batch)
    _copy_into((params, opt_state), (new_params, new_opt))
    return metrics


def _signature(tree) -> tuple:
    return tuple((name, *_leaf_key(t))
                 for name, t in tree_flatten_with_names(tree))


def _model_signature(cfg: LMConfig, mesh) -> tuple:
    """``_signature`` of ``cfg``'s parameters and AdamW state as ``train``
    makes them: placed on ``mesh`` by ``param_shardings`` and
    ``opt_shardings`` when there is one."""
    meta = transformer.init_params(cfg, torch.Generator(), device="meta")
    state = (meta, adamw.init(meta))
    if mesh is None:
        return _signature(state)
    shardings = (sharding.param_shardings(cfg, mesh, meta),
                 sharding.opt_shardings(cfg, mesh, state[1], meta))
    return tuple((name, tuple(t.shape), t.dtype, (mesh, s.placements))
                 for (name, t), s in zip(tree_flatten_with_names(state),
                                         tree_leaves(shardings), strict=True))


class _Captured(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    params: Any                          # static; the graph commits into them
    opt: adamw.AdamWState                # static, likewise
    batch: Dict[str, torch.Tensor]       # the static input the graph reads
    metrics: Dict[str, torch.Tensor]     # the static outputs the graph writes


class GraphedTrainStep:
    """``model.make_train_step(cfg, tcfg)`` as one captured program: the
    port's counterpart of the reference's ``jax.jit`` of the step, with its
    signature ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``.

    One CUDA graph for each key of jit's cache, the shapes, dtypes and
    placements of the batch's, the parameters' and the state's leaves (in
    ``train``, one for the run), captured from :func:`step_and_commit`
    after a warm-up on a side stream, over static copies of the
    parameters, the state and the batch.  A call copies the batch in, and
    the parameters and state unless they are the static ones a previous
    call returned (a fresh
    start, a resume, a rollback's restore); replays; and returns the
    static parameters, state and metrics (loss, grad norm, lr as device
    tensors), which the next call overwrites.  The step reads no value on
    the host.  Parameters or state of other shapes than ``cfg``'s model,
    or placed otherwise than ``mesh``'s rules place them (whole without a
    mesh), are refused, and so are parameters off the card.  With a
    ``mesh`` the step is ``make_train_step(..., mesh=mesh)``, the warm-up
    and the recording run under ``sharding.activation_mesh``, and the
    copies in go shard by shard.  A capture error raises as PyTorch
    raises it, a replay error as ``GraphError``; nothing falls back to
    the eager step."""

    def __init__(self, cfg: LMConfig,
                 tcfg: Optional[model.TrainStepConfig] = None,
                 mesh=None) -> None:
        self.step = model.make_train_step(cfg, tcfg, mesh=mesh)
        self.mesh = mesh
        self.signature = _model_signature(cfg, mesh)
        self.graphs: Dict[tuple, _Captured] = {}
        self.capture_seconds: List[float] = []   # host clock, warm-up included

    @staticmethod
    def key(params, opt_state, batch) -> tuple:
        return tuple(_leaf_key(t)
                     for t in tree_leaves((batch, params, opt_state)))

    def capture(self, params, opt_state: adamw.AdamWState,
                batch: Dict[str, torch.Tensor]) -> _Captured:
        """The graph of ``key(params, opt_state, batch)``, captured if it
        is new."""
        if _signature((params, opt_state)) != self.signature:
            raise ValueError("GraphedTrainStep: parameters or optimizer "
                             "state of other shapes or placements than the "
                             "model's")
        key = self.key(params, opt_state, batch)
        if key in self.graphs:
            return self.graphs[key]
        t0 = time.perf_counter()
        static = tuple(tree_map(torch.clone, x)
                       for x in (params, opt_state, batch))
        graph, metrics = self._record(*static)
        self.graphs[key] = _Captured(graph, *static, metrics)
        self.capture_seconds.append(time.perf_counter() - t0)
        return self.graphs[key]

    def _record(self, params, opt_state, batch):
        """Warm up on a side stream, then capture ``step_and_commit`` over
        the static buffers; returns the graph and its static metrics."""
        dev = tree_leaves(params)[0].device
        if dev.type != "cuda":
            raise ValueError(f"GraphedTrainStep: parameters on {dev}; a "
                             f"CUDA graph needs them on the card (the CPU "
                             f"runs the plain step)")
        stream = torch.cuda.Stream(device=dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with sharding.activation_mesh(self.mesh):
            with torch.cuda.stream(stream):
                # the warm-up commits into the static copies, which the
                # first call overwrites before it replays
                step_and_commit(self.step, params, opt_state, batch)
            with torch.cuda.graph(graph, stream=stream):
                metrics = step_and_commit(self.step, params, opt_state, batch)
        torch.cuda.current_stream(dev).wait_stream(stream)
        return graph, metrics

    def load(self, g: _Captured, params, opt_state: adamw.AdamWState,
             batch: Dict[str, torch.Tensor]) -> None:
        """Copy a call's inputs into ``g``'s static buffers: the batch
        always, the parameters and state unless they are the static ones."""
        _copy_into(g.batch, batch)
        state = (params, opt_state)
        if any(a is not b for a, b in zip(tree_leaves(state),
                                          tree_leaves((g.params, g.opt)),
                                          strict=True)):
            _copy_into((g.params, g.opt), state)

    def __call__(self, params, opt_state: adamw.AdamWState,
                 batch: Dict[str, torch.Tensor]):
        g = self.capture(params, opt_state, batch)
        self.load(g, params, opt_state, batch)
        try:
            g.graph.replay()
        except RuntimeError as e:
            raise GraphError(f"train step replay failed: {e}") from e
        return g.params, g.opt, g.metrics


def step_for_device(cfg: LMConfig, tcfg: model.TrainStepConfig, device,
                    mesh=None):
    """The train step as ``train`` runs it on ``device`` (under ``mesh``
    if one is given): a :class:`GraphedTrainStep` on the card, the plain
    step elsewhere."""
    if torch.device(device).type == "cuda":
        return GraphedTrainStep(cfg, tcfg, mesh)
    return model.make_train_step(cfg, tcfg, mesh=mesh)


def train(cfg: LMConfig, shape: ShapeSpec, loop: TrainLoopConfig,
          data_cfg: Optional[DataConfig] = None,
          fault_hook: Optional[Callable[[int], None]] = None,
          mesh=None, device="cuda") -> TrainReport:
    """Run (or resume) training; returns a report for tests/examples."""
    t0 = time.time()
    params = transformer.init_params(
        cfg, torch.Generator(device).manual_seed(0), device=device)
    opt_state = adamw.init(params)
    if mesh is not None:
        # every rank draws the same parameters from the seed
        opt_state = sharding.place_local(opt_state, sharding.opt_shardings(
            cfg, mesh, opt_state, params))
        params = sharding.place_local(params, sharding.param_shardings(
            cfg, mesh, params))

    state_like = {"params": params, "opt": opt_state}
    resumed_from = None
    start_step = 0
    restored = ckpt.restore_latest(loop.ckpt_dir, state_like, device)
    if restored is not None:
        start_step, state, _ = restored
        params, opt_state = state["params"], state["opt"]
        resumed_from = start_step

    tcfg = model.TrainStepConfig(opt=loop.opt)
    # the mesh is passed only when there is one, so that a maker of the
    # unsharded loop's signature (cfg, tcfg, device) still makes its step
    step_fn = (step_for_device(cfg, tcfg, device) if mesh is None
               else step_for_device(cfg, tcfg, device, mesh))
    graph = step_fn if isinstance(step_fn, GraphedTrainStep) else None

    data = DataIterator(cfg, shape, start_step=start_step, dcfg=data_cfg,
                        device=device)
    losses: List[float] = []
    retries = rollbacks = 0
    step = start_step

    def save(step, params, opt_state):
        ckpt.save(loop.ckpt_dir, step, {"params": params, "opt": opt_state},
                  extras={"arch": cfg.name})
        ckpt.prune(loop.ckpt_dir, keep=loop.ckpt_keep)

    if restored is None:
        save(0, params, opt_state)

    try:
        while step < loop.total_steps:
            batch = next(data)
            if mesh is not None:
                batch = sharding.place_batch(mesh, batch)
            if graph is not None:
                # outside the retry below: a capture error ends the run
                graph.capture(params, opt_state, batch)
            attempt = 0
            while True:
                try:
                    if fault_hook is not None:
                        fault_hook(step)
                    with sharding.activation_mesh(mesh):
                        new_params, new_opt, metrics = step_fn(
                            params, opt_state, batch)
                    loss = float(sharding.whole(metrics["loss"]))
                    if not math.isfinite(loss):
                        raise FloatingPointError(f"non-finite loss at {step}")
                    params, opt_state = new_params, new_opt
                    break
                except FloatingPointError:
                    # NaN circuit breaker: rollback + skip the data step
                    rollbacks += 1
                    restored = ckpt.restore_latest(loop.ckpt_dir, state_like,
                                                   device)
                    if restored is not None:
                        _, state, _ = restored
                        params, opt_state = state["params"], state["opt"]
                    elif graph is not None:
                        # the replay committed the step over the state
                        raise
                    loss = float("nan")
                    break
                except GraphError:
                    # a replay that failed may have committed part of the
                    # step: no retry, and no checkpoint of that state
                    raise
                except Exception:
                    attempt += 1
                    retries += 1
                    if attempt > loop.max_retries:
                        # persistent failure: leave a consistent checkpoint
                        save(step, params, opt_state)
                        raise
            losses.append(loss)
            step += 1
            if step % loop.ckpt_every == 0 or step == loop.total_steps:
                save(step, params, opt_state)
            if loop.log_every and step % loop.log_every == 0:
                print(f"[train] step={step} loss={loss:.4f}")
    finally:
        if graph is not None:
            graph.graphs.clear()        # the graphs' memory pools

    return TrainReport(
        steps_run=step - start_step,
        final_step=step,
        resumed_from=resumed_from,
        losses=losses,
        retries=retries,
        rollbacks=rollbacks,
        wall_seconds=time.time() - t0,
        capture_seconds=[] if graph is None else list(graph.capture_seconds),
    )
