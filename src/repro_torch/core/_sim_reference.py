"""The pre-compilation event loop, preserved as a reference engine.

This is the historical dict-keyed ``_run_streams`` implementation that
``simulator.py`` replaced with the compiled ``SimContext`` loop.  It is
kept (verbatim, minus the module it lived in) for two jobs:

* **equivalence oracle** — ``tests/test_sim_property.py`` drives random
  DAGs x assignments x replica configs through both loops and asserts
  bit-identical outputs, a far stronger net than the fixed goldens;
* **honest speedup measurement** — ``benchmarks/sim_speed.py`` times
  this loop against the compiled one on the real workloads and records
  the ratio in ``BENCH_sim.json``.

Do not "fix" or optimize this module: its value is being frozen.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

from .simulator import IMCESimulator, MultiTenantSimulator


class _ReferenceLoopMixin:
    """Overrides ``_run_streams`` with the historical implementation."""

    def _run_streams(
        self, a, frames, in_flight: int,
        rates: Optional[Dict[str, float]] = None,
        light: bool = False,  # signature compat; the oracle always
        # materializes everything (the loop below is the frozen original)
    ) -> Tuple[float, Dict[str, List[float]],
               Dict[int, List[Tuple[float, float]]],
               Dict[str, List[float]], Dict[str, Dict[int, float]]]:
        g, cm = self.g, self.cm
        view = self._stream_view(a)
        if isinstance(frames, int):
            frames = {s: frames for s in view.streams}
        order = g.topo_order()
        preds = {n: g.predecessors(n) for n in order}
        succs = {n: g.successors(n) for n in order}
        streams = view.streams

        pu_of = dict(a.mapping)
        for nid in order:
            if nid not in pu_of:
                nbr = succs[nid] + preds[nid]
                pu_of[nid] = next(
                    (pu_of[m] for m in nbr if m in pu_of), a.pus[0].pu_id
                )
        speed = {p.pu_id: p for p in a.pus}

        rep_cnt = {n: g.nodes[n].replica_count for n in order}
        rep_idx = {n: g.nodes[n].meta.get("replica_index", 0) for n in order}
        replicated = any(c > 1 for c in rep_cnt.values())

        def active(nid: int, f: int) -> bool:
            c = rep_cnt[nid]
            return c == 1 or f % c == rep_idx[nid]

        def exec_time(nid: int) -> float:
            node = g.nodes[nid]
            if node.is_free():
                return 0.0
            pu = speed[pu_of[nid]]
            return cm.time(node, pu.pu_type, pu.speed)

        evq: List[Tuple[float, int, str, tuple]] = []
        seq = 0

        def push(t: float, kind: str, payload: tuple) -> None:
            nonlocal seq
            heapq.heappush(evq, (t, seq, kind, payload))
            seq += 1

        missing: Dict[Tuple[str, int, int], int] = {}
        inject_time: Dict[Tuple[str, int], float] = {}
        complete_time: Dict[Tuple[str, int], float] = {}
        frame_left: Dict[Tuple[str, int], int] = {}
        injected = {s: 0 for s in streams}
        n_sinks = {s: len(view.sinks[s]) for s in streams}
        ready_q: Dict[int, List[Tuple[float, int, float, int, float]]] = {
            p.pu_id: [] for p in a.pus
        }
        pu_free_at: Dict[int, float] = {p.pu_id: 0.0 for p in a.pus}
        pu_idle: Dict[int, bool] = {p.pu_id: True for p in a.pus}
        busy_iv: Dict[int, List[Tuple[float, float]]] = {p.pu_id: [] for p in a.pus}
        stream_busy: Dict[str, Dict[int, float]] = {
            s: {p.pu_id: 0.0 for p in a.pus} for s in streams
        }
        completions: Dict[str, List[float]] = {s: [] for s in streams}

        def inject(sn: str, f: int, t: float) -> None:
            inject_time[(sn, f)] = t
            if not replicated:
                frame_left[(sn, f)] = n_sinks[sn]
                for nid in view.nodes[sn]:
                    missing[(sn, f, nid)] = len(preds[nid])
                for nid in view.sources[sn]:
                    push(t, "ready", (sn, f, nid))
            else:
                sinks = 0
                for nid in view.nodes[sn]:
                    if not active(nid, f):
                        continue
                    missing[(sn, f, nid)] = sum(
                        1 for p in preds[nid] if active(p, f))
                    if not any(active(s, f) for s in succs[nid]):
                        sinks += 1
                    if missing[(sn, f, nid)] == 0:
                        push(t, "ready", (sn, f, nid))
                frame_left[(sn, f)] = sinks
            injected[sn] += 1

        def enqueue_ready(sn: str, f: int, nid: int, t: float) -> None:
            pid = pu_of[nid]
            heapq.heappush(
                ready_q[pid],
                (f * view.weight[sn], f, -self._blevel[nid], nid, t))
            if pu_idle[pid]:
                push(max(t, pu_free_at[pid]), "dispatch", (pid,))

        def finish(sn: str, f: int, nid: int, t: float) -> None:
            node = g.nodes[nid]
            outs = succs[nid]
            if replicated:
                outs = [s for s in outs if active(s, f)]
            if not outs:
                frame_left[(sn, f)] -= 1
                if frame_left[(sn, f)] == 0:
                    completions[sn].append(t)
                    complete_time[(sn, f)] = t
                    push(t, "complete", (sn, f))
                return
            for s in outs:
                xfer = cm.transfer(node, same_pu=(pu_of[s] == pu_of[nid]))
                push(t + xfer, "arrive", (sn, f, s))

        if rates is not None:
            for sn in streams:
                r = rates[sn]
                if r <= 0:
                    raise ValueError(f"rate for stream '{sn}' must be > 0")
                for f in range(frames[sn]):
                    push(f / r, "inject", (sn, f))
        else:
            for sn in streams:
                for f in range(min(in_flight, frames[sn])):
                    inject(sn, f, 0.0)

        makespan = 0.0
        while evq:
            t, _, kind, payload = heapq.heappop(evq)
            makespan = max(makespan, t)
            if kind == "inject":
                sn, f = payload
                inject(sn, f, t)
            elif kind == "ready":
                sn, f, nid = payload
                enqueue_ready(sn, f, nid, t)
            elif kind == "arrive":
                sn, f, nid = payload
                missing[(sn, f, nid)] -= 1
                if missing[(sn, f, nid)] == 0:
                    push(t, "ready", (sn, f, nid))
            elif kind == "dispatch":
                (pid,) = payload
                if not pu_idle[pid] or not ready_q[pid]:
                    continue
                _vt, f, _negbl, nid, _tr = heapq.heappop(ready_q[pid])
                sn = view.stream_of[nid]
                dt = exec_time(nid)
                pu_idle[pid] = False
                start = max(t, pu_free_at[pid])
                end = start + dt
                pu_free_at[pid] = end
                if dt > 0:
                    busy_iv[pid].append((start, end))
                    stream_busy[sn][pid] += dt
                push(end, "done", (pid, sn, f, nid))
            elif kind == "done":
                pid, sn, f, nid = payload
                pu_idle[pid] = True
                finish(sn, f, nid, t)
                if ready_q[pid]:
                    push(t, "dispatch", (pid,))
            elif kind == "complete":
                sn, f = payload
                if rates is None and injected[sn] < frames[sn]:
                    inject(sn, injected[sn], t)
        sojourns = {
            sn: [complete_time[(sn, f)] - inject_time[(sn, f)]
                 for f in range(frames[sn]) if (sn, f) in complete_time]
            for sn in streams
        }
        self.last_events = seq
        return (makespan, {s: sorted(c) for s, c in completions.items()},
                busy_iv, sojourns, stream_busy)


class ReferenceSimulator(_ReferenceLoopMixin, IMCESimulator):
    """Single-model simulator running the historical event loop."""


class ReferenceMultiTenantSimulator(_ReferenceLoopMixin, MultiTenantSimulator):
    """Multi-tenant simulator running the historical event loop."""
