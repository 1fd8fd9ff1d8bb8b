"""Batched serving loop: continuous-batching-style request scheduler over
the prefill/decode steps.

Counterpart of ``repro.runtime.serve_loop``.  Requests arrive with
prompts; the server packs up to ``max_batch`` of them, left-pads the
prompts with token 0 to the widest (the pads are attended to, and
positions count from the first pad, as in the reference), prefills once,
then decodes in lockstep, retiring sequences on EOS or length budget.
Fault tolerance: a decode-step failure (``RuntimeError``) re-runs prefill
for the live slots with everything generated so far (caches are
reconstructible state, never durable).  The server runs on the device of
the parameters it is given.

Parameters that are DTensors (placed on a mesh by
``sharding.param_shardings``) are served sharded, as the reference serves
parameters that ``jax.device_put`` placed: the server reads the mesh from
the embedding table, places each padded batch by
``sharding.batch_shardings``, runs both steps under
``sharding.activation_mesh``, feeds the decode step the cache as the
sharded prefill returns it, and reads each token on the host whole.

The reference compiles both of its steps with ``jax.jit``.  The port's
counterparts on the card are ``GraphedPrefill`` and ``GraphedDecode``:
each step captured into a CUDA graph once per key of jit's cache (the
prefill once per batch and prompt width, the decode step once per batch
and ``s_max``; under a mesh the inputs' placements too) and replayed, with
sharded parameters as with whole ones.  On the CPU (a gloo mesh
included) the server runs both plain steps.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..configs.base import LMConfig
from ..kernels import counts
from ..kernels.flash_attention import flash_attention
from ..models.lm import model, sharding
from ..models.lm.transformer import ServeCache
from ..tree import tree_leaves, tree_map


@dataclass
class Request:
    rid: int
    prompt: torch.Tensor         # (S,) integer token ids
    max_new: int = 16
    eos: Optional[int] = None
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


@dataclass
class ServeStats:
    served: int = 0
    prefills: int = 0
    decode_steps: int = 0
    retries: int = 0
    wall_seconds: float = 0.0


def _mesh_of(params):
    """The mesh of sharded parameters (the embedding table's); None for
    whole ones."""
    return getattr(params["embed"], "device_mesh", None)


def _leaf_key(t: torch.Tensor) -> tuple:
    """A leaf's part of jit's cache key: its shape, dtype and sharding."""
    return tuple(t.shape), t.dtype, sharding.placement_of(t)


def _copy_into(dst, src) -> None:
    """Copy each leaf of ``src`` into the leaf of ``dst``, shard by shard.
    A DTensor's placements must be its destination's: a copy never
    redistributes, so a capture records no collective."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src), strict=True):
        if sharding.placement_of(d) != sharding.placement_of(s):
            raise ValueError(f"copy between placements "
                             f"{sharding.placement_of(s)} and "
                             f"{sharding.placement_of(d)}")
        sharding.local_tensor(d).copy_(sharding.local_tensor(s))


class GraphError(Exception):
    """A CUDA graph's replay failed.  Not a ``RuntimeError``, so that
    ``Server`` ends the run on it instead of re-prefilling (a capture runs
    before the retry's ``try``)."""


class _Captured(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    token: torch.Tensor          # the static inputs the graph reads
    cache: ServeCache            # static; the graph updates it in place
    logits: torch.Tensor         # the static output the graph writes


class GraphedDecode:
    """``model.make_decode_step(cfg)`` as one captured program: the port's
    counterpart of the reference's ``jax.jit`` of the step, with its
    signature ``(params, token, cache) -> (logits, cache)``.

    One CUDA graph for each key of jit's cache, the shapes, dtypes and
    placements of the token and of every cache leaf (in ``Server``, the
    batch and ``s_max``), captured from the plain step after a warm-up on
    a side stream, over static copies of the token and the cache.  A call
    copies the token, and the cache's entries and ``cur_pos`` unless the
    cache is the static one a previous call returned, into the static
    buffers, replays, and returns the static logits and cache: the logits
    are overwritten by the next call.  The step never reads the position
    on the host, so a replay advances it on the card.  The graph holds the
    parameters it was captured with, and a call with others is refused.

    Sharded parameters are captured as whole ones: the static buffers are
    DTensors with the inputs' placements, the warm-up and the recording
    run under ``sharding.activation_mesh``, and a call copies into the
    static DTensors' local shards."""

    def __init__(self, cfg: LMConfig, params) -> None:
        self.step = model.make_decode_step(cfg)
        self.params = params
        self.mesh = _mesh_of(params)
        self.graphs: Dict[tuple, _Captured] = {}
        self.capture_seconds: List[float] = []   # host clock, warm-up included

    @staticmethod
    def key(token: torch.Tensor, cache: ServeCache) -> tuple:
        return tuple(_leaf_key(t) for t in (token, *tree_leaves(cache)))

    def capture(self, params, token: torch.Tensor,
                cache: ServeCache) -> _Captured:
        """The graph of ``key(token, cache)``, captured if it is new."""
        if params is not self.params:
            raise ValueError("GraphedDecode: called with parameters other "
                             "than those it captures with")
        key = self.key(token, cache)
        if key in self.graphs:
            return self.graphs[key]
        t0 = time.perf_counter()
        static_token = token.clone()
        static_cache = tree_map(torch.clone, cache)
        stream = torch.cuda.Stream(device=token.device)
        stream.wait_stream(torch.cuda.current_stream(token.device))
        graph = torch.cuda.CUDAGraph()
        with sharding.activation_mesh(self.mesh):
            with torch.cuda.stream(stream):
                # the warm-up updates the static copies, which every call
                # overwrites before it replays
                self.step(params, static_token, static_cache)
            with torch.cuda.graph(graph, stream=stream):
                logits, _ = self.step(params, static_token, static_cache)
        torch.cuda.current_stream(token.device).wait_stream(stream)
        self.graphs[key] = _Captured(graph, static_token, static_cache, logits)
        self.capture_seconds.append(time.perf_counter() - t0)
        return self.graphs[key]

    def __call__(self, params, token: torch.Tensor, cache: ServeCache):
        g = self.capture(params, token, cache)
        _copy_into(g.token, token)
        if any(a is not b for a, b in zip(tree_leaves(cache),
                                          tree_leaves(g.cache), strict=True)):
            _copy_into(g.cache, cache)  # a new prefill's cache
        try:
            g.graph.replay()
        except RuntimeError as e:
            raise GraphError(f"decode step replay failed: {e}") from e
        return g.logits, g.cache


#: the wrappers a prefill counts: (wrapper, name of its by-instance dict)
_COUNTED = ((flash_attention, "instance_launches"),)


def _shapes(tree) -> tuple:
    return tuple(_leaf_key(t) for t in tree_leaves(tree))


class _Prefill(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    batch: Dict[str, torch.Tensor]   # the static inputs the graph reads
    out: tuple                       # the static (logits, cache) it writes
    launches: tuple                  # the flash launches a replay runs


class GraphedPrefill:
    """``model.make_prefill_step(cfg, s_max)`` as one captured program a
    prompt shape: the port's counterpart of the reference's ``jax.jit`` of
    the step, with its signature ``(params, batch) -> (logits, cache)``.

    One CUDA graph for each key of jit's cache, the names, shapes, dtypes
    and placements of the batch's tensors (in ``Server``, the batch and
    the prompt width; ``s_max`` is the server's), captured from the plain
    step after a warm-up on a side stream, over static copies of the
    batch.  Each
    graph ends by copying the step's logits and cache into static outputs
    that every width shares: their shapes are the batch's and ``s_max``'s,
    not the width's, so there is one set a batch size.  Everything else a
    capture allocates, the step's own outputs included, lies in one memory
    pool shared by every capture, which holds the largest width's scratch
    once.  So a new width adds its graph and its static inputs, and no
    device memory beside them: the cache grows as jit's cache of
    executables grows.

    A call of a width already captured copies the batch into its static
    inputs and replays; the call that captures a width returns what the
    warm-up computed from the same batch, so a new width costs one plain
    step and the recording, and the call's time includes both.  Either
    way the call returns the static outputs: **a call's logits and cache
    are valid until the next call of any width**.  Clone what must
    outlive it.  (``Server`` needs nothing longer: its decode graph
    copies a new prefill's cache into its own buffers before the next
    prefill runs.)  The shared pool is safe because nothing a replay
    leaves in it is read afterwards: the inputs and outputs lie outside
    it, and replays run one at a time on the caller's stream.

    The graph holds the parameters it was captured with, and a call with
    others is refused.  A replay failure raises ``GraphError``.  The flash
    wrapper's counts say how many launches ran: a capture takes back the
    launches it records and every replay adds them (``kernels.counts``).
    ``capture_seconds`` holds each capture's host seconds, warm-up
    included.  Sharded parameters are captured as ``GraphedDecode``
    captures them; the static outputs take the step's placements."""

    def __init__(self, cfg: LMConfig, params, s_max: int) -> None:
        self.step = model.make_prefill_step(cfg, s_max=s_max)
        self.params = params
        self.mesh = _mesh_of(params)
        self.graphs: Dict[tuple, _Prefill] = {}
        self.outputs: Dict[tuple, tuple] = {}    # by the outputs' shapes
        self.pool = None        # the shared pool and the side stream, made
        self.stream = None      # at the first capture (they need the card)
        self.capture_seconds: List[float] = []

    @staticmethod
    def key(batch: Dict[str, torch.Tensor]) -> tuple:
        return tuple((name, *_leaf_key(t))
                     for name, t in sorted(batch.items()))

    def capture(self, params, batch: Dict[str, torch.Tensor]) -> _Prefill:
        """The graph of ``key(batch)``, captured if it is new; a new
        graph's static outputs then hold the step's result for ``batch``."""
        if params is not self.params:
            raise ValueError("GraphedPrefill: called with parameters other "
                             "than those it captures with")
        key = self.key(batch)
        if key in self.graphs:
            return self.graphs[key]
        t0 = time.perf_counter()
        dev = batch["tokens"].device
        main = torch.cuda.current_stream(dev)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(device=dev)
        static = {name: t.clone() for name, t in batch.items()}
        with sharding.activation_mesh(self.mesh):
            self.stream.wait_stream(main)
            with torch.cuda.stream(self.stream):
                warm = self.step(params, static)     # warm-up: it runs
            out = self.outputs.get(_shapes(warm))
            if out is None:
                out = self.outputs[_shapes(warm)] = tree_map(
                    torch.empty_like, warm)
            self.stream.wait_stream(main)
            with torch.cuda.stream(self.stream):
                _copy_into(out, warm)
            del warm
            graph = torch.cuda.CUDAGraph()
            before = counts.snapshot(_COUNTED)
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                _copy_into(out, self.step(params, static))
        launches = counts.delta(counts.snapshot(_COUNTED), before)
        counts.add(_COUNTED, launches, -1)
        main.wait_stream(self.stream)
        self.graphs[key] = _Prefill(graph, static, out, launches)
        self.capture_seconds.append(time.perf_counter() - t0)
        return self.graphs[key]

    def __call__(self, params, batch: Dict[str, torch.Tensor]):
        new = self.key(batch) not in self.graphs
        g = self.capture(params, batch)
        if not new:
            _copy_into(g.batch, batch)
            try:
                g.graph.replay()
            except RuntimeError as e:
                raise GraphError(f"prefill replay failed: {e}") from e
            counts.add(_COUNTED, g.launches, 1)
        return g.out


class Server:
    def __init__(self, cfg: LMConfig, params, max_batch: int = 4,
                 s_max: int = 128, fault_hook=None) -> None:
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.mesh = _mesh_of(params)
        self.max_batch = max_batch
        self.s_max = s_max
        # the reference's jax.jit of each step: CUDA graphs on the card,
        # for whole and sharded parameters alike; the CPU takes the plain
        # steps
        self.prefill_graph: Optional[GraphedPrefill] = None
        self.graph: Optional[GraphedDecode] = None
        self.prefill = model.make_prefill_step(cfg, s_max=s_max)
        self.decode = model.make_decode_step(cfg)
        if self.device.type == "cuda":
            self.prefill_graph = self.prefill = GraphedPrefill(cfg, params,
                                                               s_max)
            self.graph = self.decode = GraphedDecode(cfg, params)
        self.fault_hook = fault_hook

    def _pad_prompts(self, reqs: List[Request]) -> torch.Tensor:
        prompts = [torch.as_tensor(r.prompt, dtype=torch.long) for r in reqs]
        width = max(int(p.shape[0]) for p in prompts)
        rows = [F.pad(p, (width - int(p.shape[0]), 0)) for p in prompts]
        tokens = torch.stack(rows).to(self.device)
        if self.mesh is None:
            return tokens
        return sharding.place_batch(self.mesh, {"tokens": tokens})["tokens"]

    def _prefill(self, reqs: List[Request], stats: ServeStats):
        # outside any try: a new width's capture, or a capture or replay
        # error, ends up in the caller's hands, the retry's re-prefill too
        out = self.prefill(self.params, {"tokens": self._pad_prompts(reqs)})
        stats.prefills += 1
        return out

    def serve(self, requests: List[Request]) -> ServeStats:
        t0 = time.perf_counter()
        stats = ServeStats()
        queue = list(requests)
        while queue:
            live = queue[: self.max_batch]
            queue = queue[self.max_batch:]
            with sharding.activation_mesh(self.mesh):
                self._run_batch(live, stats)
            stats.served += len(live)
        stats.wall_seconds = time.perf_counter() - t0
        return stats

    def _run_batch(self, live: List[Request], stats: ServeStats) -> None:
        logits, cache = self._prefill(live, stats)
        cur = torch.argmax(logits[:, -1:], dim=-1)
        max_new = max(r.max_new for r in live)
        for step in range(max_new):
            host = sharding.whole(cur)[:, 0].tolist()
            for i, r in enumerate(live):
                if not r.done and len(r.out_tokens) < r.max_new:
                    tok = host[i]
                    r.out_tokens.append(tok)
                    if r.eos is not None and tok == r.eos:
                        r.done = True
                elif len(r.out_tokens) >= r.max_new:
                    r.done = True
            if all(r.done for r in live):
                break
            if self.graph is not None:
                # outside the retry below: a capture error ends the run
                self.graph.capture(self.params, cur, cache)
            try:
                if self.fault_hook is not None:
                    self.fault_hook(stats.decode_steps)
                logits, cache = self.decode(self.params, cur, cache)
            except RuntimeError:
                # decode failure: caches are reconstructible — re-prefill
                # with everything generated so far and continue
                stats.retries += 1
                ext = []
                for r in live:
                    prompt = torch.as_tensor(r.prompt, dtype=torch.long)
                    gen = torch.tensor(r.out_tokens, dtype=torch.long,
                                       device=prompt.device)
                    ext.append(torch.cat([prompt, gen]))
                logits, cache = self._prefill(
                    [Request(r.rid, e, r.max_new) for r, e in zip(live, ext)],
                    stats)
            stats.decode_steps += 1
            cur = torch.argmax(logits[:, -1:], dim=-1)
