"""The served prefill as the reference's ``jax.jit`` compiles it: one CUDA
graph a prompt shape (``runtime.serve_loop.GraphedPrefill``).

A capture runs only on the card, so the CPU holds what decides whether a
capture is right and safe: the graph cache's key (jit's: the batch's
shapes and dtypes), the refusal of other parameters before anything runs,
a prefill that never reads a value on the host (a read would stall or
break a capture), ``Server``'s plain prefill on the CPU against the
reference's, prefill outputs of one shape at every width of a batch
size, and, under stand-ins for the CUDA graph machinery,
``GraphedPrefill`` itself (one graph a shape, one pool for every capture,
one set of static outputs for every width, so that a width holds only its
static inputs beside them, the flash launch counts, a replay error) and
how ``Server`` drives it (a new width captured by the prefill call, the
retry's too, and no return to the eager step after a capture or replay
error).
``chip_smoke.py`` holds the graphed prefill against the plain one on the
card (``prefill_graph_against_plain``).

Tolerance: on a two-layer f32 cut the port's ``Server`` gives the
reference server's greedy tokens (``tests/test_torch_decode_state.py``'s
case); under the stand-ins the replayed outputs are ``torch.equal`` to
the plain step's, as the same ops on the same inputs are."""

import contextlib
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.lm import model, transformer
from repro_torch.runtime import serve_loop
from repro_torch.runtime.serve_loop import (GraphedPrefill, GraphError,
                                            Request, Server)
from repro_torch.tree import tree_leaves

B = 2


def _cut(cfg, ns):
    return dataclasses.replace(cfg, segments=tuple(
        dataclasses.replace(s, n=n) for s, n in zip(cfg.segments, ns)))


def _params(cfg, seed=0):
    return transformer.init_params(cfg, torch.Generator().manual_seed(seed),
                                   device="cpu")


def _tokens(cfg, width, batch=B, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (batch, width)))


def test_key_is_the_batch_shape_and_dtype():
    """A graph for each (batch, prompt width), as jit's cache is keyed by
    shapes and dtypes: a clone keys the same, another width or batch
    another graph."""
    cfg = get_config("gemma3-1b").smoke()
    toks = _tokens(cfg, 9)
    key = GraphedPrefill.key
    assert key({"tokens": toks}) == key({"tokens": toks.clone()})
    assert key({"tokens": toks}) != key({"tokens": toks[:, 1:]})
    assert key({"tokens": toks}) != key({"tokens": toks[:1]})
    assert key({"tokens": toks}) != key({"tokens": toks.int()})


def test_other_parameters_are_refused_before_anything_runs():
    """A call or a capture with other parameters than the graph's raises
    before anything is captured, and before the pool or the stream (both
    need the card) is made."""
    cfg = get_config("gemma3-1b").smoke()
    params = _params(cfg)
    graphed = GraphedPrefill(cfg, params, s_max=16)
    other = transformer.tree_map(torch.clone, params)
    batch = {"tokens": _tokens(cfg, 6)}
    for fn in (graphed.capture, graphed):
        with pytest.raises(ValueError, match="parameters other"):
            fn(other, batch)
    assert not graphed.graphs and not graphed.capture_seconds
    assert graphed.pool is None and graphed.stream is None


def test_server_on_the_cpu_keeps_the_plain_prefill():
    """No prefill graph on the CPU; on a two-layer f32 cut, with prompts
    packed into batches of three widths, the server's tokens are the
    reference server's."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.models.lm import transformer as jtransformer
    from repro.runtime.serve_loop import Request as JRequest
    from repro.runtime.serve_loop import Server as JServer
    from repro_torch.weights import from_jax_params
    jc = _cut(jget_config("gemma3-1b").smoke(), (2,))
    tc = _cut(get_config("gemma3-1b").smoke(), (2,))
    jparams = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32),
        jtransformer.init_params(jc, jax.random.PRNGKey(0)))
    params = from_jax_params(jparams, "cpu")
    server = Server(tc, params, max_batch=2, s_max=32)
    assert server.prefill_graph is None
    assert not isinstance(server.prefill, GraphedPrefill)
    widths = []
    pre = server.prefill

    def prefill(p, batch):
        widths.append(batch["tokens"].shape[1])
        return pre(p, batch)

    server.prefill = prefill
    jserver = JServer(jc, jparams, max_batch=2, s_max=32)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jc.vocab, n).astype(np.int32)
               for n in (7, 12, 5, 9, 15, 3)]
    reqs = [Request(i, torch.from_numpy(p), max_new=6)
            for i, p in enumerate(prompts)]
    jreqs = [JRequest(i, jnp.asarray(p), max_new=6)
             for i, p in enumerate(prompts)]
    stats, jstats = server.serve(reqs), jserver.serve(jreqs)
    assert widths == [12, 9, 15]
    assert stats.prefills == jstats.prefills == 3 and stats.retries == 0
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]


class _NoHostReads(TorchDispatchMode):
    """Fails on any op that copies a tensor's value to the host
    (``item()``, ``int()``, ``tolist()`` of one element), but inside
    ``F.one_hot`` (the MoE dispatch's): on the CPU PyTorch checks its
    classes on the host, on the card a device assert checks them."""

    def __init__(self, monkeypatch):
        super().__init__()
        self.in_one_hot = False
        one_hot = torch.nn.functional.one_hot

        def checked_on_the_card(*args, **kwargs):
            self.in_one_hot = True
            try:
                return one_hot(*args, **kwargs)
            finally:
                self.in_one_hot = False
        monkeypatch.setattr(torch.nn.functional, "one_hot", checked_on_the_card)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default \
                and not self.in_one_hot:
            raise AssertionError("the prefill step read a value on the host")
        return func(*args, **(kwargs or {}))


def _batch(cfg, gen, S):
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen)}
    if cfg.is_encdec():
        batch["enc_frames"] = torch.randn((B, 24, cfg.enc_frame_dim),
                                          generator=gen).to(torch.bfloat16)
    if cfg.num_prefix_tokens:
        batch["prefix"] = torch.randn(
            (B, cfg.num_prefix_tokens, cfg.prefix_dim),
            generator=gen).to(torch.bfloat16)
    return batch


@pytest.mark.parametrize("arch", ["gemma3-1b", "granite-moe-3b-a800m",
                                  "falcon-mamba-7b", "recurrentgemma-9b",
                                  "whisper-small", "paligemma-3b"])
def test_prefill_reads_no_value_on_the_host(arch, monkeypatch):
    """The prefill step runs under a dispatch mode that fails on a read of
    a value on the host: nothing in it waits for the card, so its capture
    records the whole step.  Its outputs are the same as without the
    mode."""
    cfg = get_config(arch).smoke()
    gen = torch.Generator().manual_seed(0)
    params = transformer.init_params(cfg, gen, device="cpu")
    S = 10
    batch = _batch(cfg, gen, S)
    step = model.make_prefill_step(cfg, S + cfg.num_prefix_tokens + 3)
    with _NoHostReads(monkeypatch):
        logits, cache = step(params, batch)
    want_logits, want_cache = step(params, batch)
    assert torch.equal(logits, want_logits)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(cache), tree_leaves(want_cache), strict=True))
    assert int(cache.cur_pos) == S + cfg.num_prefix_tokens


# ---------------------------------------------------------------------------
# GraphedPrefill under stand-ins for the CUDA graph machinery
# ---------------------------------------------------------------------------

POOL = (0, 7)


@pytest.fixture
def stand_ins(monkeypatch):
    """The CUDA graph machinery stood in for on the CPU, as a capture there
    leaves it: the "captured" body has run once, so a replay re-runs the
    graph's ``rerun`` (what the card's replay does: recompute the static
    outputs from the static inputs).  Each capture's pool is recorded; the
    ``fail_capture``-th capture and the ``fail_replay``-th replay (counted
    over every graph) fail as PyTorch's do, with a ``RuntimeError``."""
    st = types.SimpleNamespace(pools=[], captures=0, replays=0,
                               fail_capture=None, fail_replay=None)

    class Graph:
        def __init__(self):
            self.replays = 0
            self.rerun = None

        def replay(self):
            st.replays += 1
            if st.replays == st.fail_replay:
                raise RuntimeError("replay failed")
            self.replays += 1
            if self.rerun is not None:
                self.rerun()

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None):
        st.pools.append(pool)
        st.captures += 1
        if st.captures == st.fail_capture:
            raise RuntimeError("capture failed")
        yield

    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: POOL)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(flash_attention, "launches", 0)
    monkeypatch.setattr(flash_attention, "instance_launches",
                        dict.fromkeys(flash_attention.instance_launches, 0))
    return st


def _counting(graphed, per_step=3, widths=None):
    """``graphed``'s step made to count ``per_step`` flash launches (on the
    tensor-core instance), as the card's step does, and to append its
    prompt width to ``widths``; returns the plain step."""
    plain = graphed.step

    def step(params, batch):
        flash_attention.launches += per_step
        flash_attention.instance_launches["tensor_core"] += per_step
        if widths is not None:
            widths.append(batch["tokens"].shape[1])
        return plain(params, batch)

    graphed.step = step
    return plain


def _recompute(plain, params, c):
    def rerun():
        serve_loop._copy_into(c.out, plain(params, c.batch))
    return rerun


def _replaying(graphed, plain):
    """Each graph ``graphed`` captures made to recompute at its replays."""
    capture = graphed.capture

    def captured(params, batch):
        c = capture(params, batch)
        c.graph.rerun = _recompute(plain, params, c)
        return c

    graphed.capture = captured


def _equal(got, want):
    return all(torch.equal(a, b) for a, b in zip(
        tree_leaves(got), tree_leaves(want), strict=True))


def _graphed_server(fault_at=None):
    """A stablelm smoke ``Server`` whose prefill is a ``GraphedPrefill``
    (under the stand-ins), a decode fault at step ``fault_at``; returns
    the server, the graph and the widths its step ran at."""
    cfg = get_config("stablelm-1.6b").smoke()
    params = _params(cfg)

    def hook(step):
        if step == fault_at:
            raise RuntimeError("injected decode fault")

    server = Server(cfg, params, max_batch=2, s_max=32, fault_hook=hook)
    graphed = GraphedPrefill(cfg, params, s_max=32)
    widths = []
    _replaying(graphed, _counting(graphed, widths=widths))
    server.prefill_graph = server.prefill = graphed
    return server, graphed, widths


def _requests():
    return [Request(0, torch.arange(1, 6), max_new=4),
            Request(1, torch.arange(2, 5), max_new=4)]


def test_retry_captures_its_new_width_before_it_prefills(stand_ins):
    """A decode fault at step 1 re-prefills the prompt with the two tokens
    generated so far: that new width is captured by the prefill call
    itself, before its outputs are used, as the first prefill's was; the
    tokens are a plain server's under the same fault."""
    server, graphed, widths = _graphed_server(fault_at=1)
    reqs = _requests()
    stats = server.serve(reqs)
    assert stats.retries == 1 and stats.prefills == 2
    assert [k[0][1] for k in graphed.graphs] == [(2, 5), (2, 7)]
    assert widths == [5, 5, 7, 7]           # each a warm-up and a capture
    assert len(graphed.capture_seconds) == 2 and stand_ins.replays == 0
    plain, _, _ = _graphed_server(fault_at=1)
    plain.prefill_graph = None
    plain.prefill = model.make_prefill_step(plain.cfg, s_max=32)
    want = _requests()
    plain.serve(want)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in want]


@pytest.mark.parametrize("fail_at,exc", [("capture", RuntimeError),
                                         ("replay", GraphError)])
@pytest.mark.parametrize("nth", [1, 2])
def test_graph_errors_end_the_run(fail_at, exc, nth, stand_ins):
    """A capture or replay error of the first prefill, or of the retry's
    re-prefill, ends the run: nothing catches it, no eager prefill runs in
    its place, and no later prefill follows.  (The replay case captures
    both widths first, so that both prefills replay.)"""
    server, graphed, widths = _graphed_server(fault_at=1)
    if fail_at == "replay":
        for w in (5, 7):
            graphed.capture(server.params,
                            {"tokens": torch.arange(w).unsqueeze(0)})
        del widths[:]
        stand_ins.fail_replay = nth
    else:
        stand_ins.fail_capture = nth
    with pytest.raises(exc, match=f"{fail_at} failed"):
        server.serve([Request(0, torch.arange(1, 6), max_new=4)])
    if fail_at == "replay":
        assert stand_ins.replays == nth and widths == []
    else:
        # the failing capture's warm-up ran, then nothing more
        assert len(graphed.graphs) == nth - 1
        assert widths == [5, 5, 7][:2 * nth - 1]


def test_graphed_prefill_under_stand_ins(stand_ins):
    """One graph a width, every capture in the one shared pool; the call
    that captures returns its warm-up's outputs, a later call copies the
    batch into the static inputs and replays; both return the static
    outputs, which every width shares, equal to the plain step's; a
    repeated width captures nothing; the flash counts say what ran (each
    capture's warm-up and each replay, not the capture)."""
    cfg = get_config("gemma3-1b").smoke()
    params = _params(cfg)
    graphed = GraphedPrefill(cfg, params, s_max=24)
    plain = _counting(graphed)
    toks = [_tokens(cfg, 9, seed=s) for s in range(2)]

    out = graphed(params, {"tokens": toks[0]})
    (key, c), = graphed.graphs.items()
    assert key == GraphedPrefill.key({"tokens": toks[0]})
    assert out is c.out and c.batch["tokens"] is not toks[0]
    assert c.graph.replays == 0 and c.launches == ((3, {
        k: 3 * (k == "tensor_core")
        for k in flash_attention.instance_launches}),)
    assert flash_attention.launches == 3            # the warm-up
    assert _equal(out, plain(params, {"tokens": toks[0]}))

    c.graph.rerun = _recompute(plain, params, c)
    out = graphed(params, {"tokens": toks[1]})
    assert len(graphed.graphs) == 1 and len(graphed.capture_seconds) == 1
    assert c.graph.replays == 1 and flash_attention.launches == 6
    assert out is c.out and torch.equal(c.batch["tokens"], toks[1])
    assert _equal(out, plain(params, {"tokens": toks[1]}))

    short = {"tokens": toks[1][:, 2:]}              # a new width
    out = graphed(params, short)
    assert len(graphed.graphs) == 2 and len(graphed.capture_seconds) == 2
    assert stand_ins.pools == [POOL, POOL] and graphed.pool == POOL
    assert out is c.out and len(graphed.outputs) == 1
    assert _equal(out, plain(params, short))
    assert flash_attention.launches == 6 + 3
    assert flash_attention.instance_launches["tensor_core"] == 9


def test_graphed_prefill_replay_error_is_a_graph_error(stand_ins):
    """A replay failure raises ``GraphError`` (not a ``RuntimeError``, so
    ``Server`` does not re-prefill on it) and counts no launch."""
    cfg = get_config("gemma3-1b").smoke()
    params = _params(cfg)
    graphed = GraphedPrefill(cfg, params, s_max=16)
    batch = {"tokens": _tokens(cfg, 6)}
    graphed.capture(params, batch)
    launches = flash_attention.launches
    stand_ins.fail_replay = 1
    with pytest.raises(GraphError, match="prefill replay failed"):
        graphed(params, batch)
    assert not isinstance(GraphError("x"), RuntimeError)
    assert flash_attention.launches == launches and len(graphed.graphs) == 1


def _held_bytes(graphed) -> int:
    """The bytes of the distinct tensors a ``GraphedPrefill`` holds: its
    graphs' static inputs and outputs."""
    held = {}
    for t in tree_leaves([[c.batch, c.out] for c in graphed.graphs.values()]):
        held[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
    return sum(held.values())


def test_memory_held_grows_by_the_static_inputs_alone(stand_ins):
    """Twelve prompt widths at one batch size: one set of static outputs,
    which every call returns, and each new width adds no more than its
    static tokens to what the graphs hold; every call's outputs are the
    plain step's."""
    cfg = get_config("gemma3-1b").smoke()
    params = _params(cfg)
    graphed = GraphedPrefill(cfg, params, s_max=40)
    plain = _counting(graphed)
    _replaying(graphed, plain)
    widths = list(range(3, 39, 3))
    held = []
    for i, w in enumerate(widths + widths[:3]):
        batch = {"tokens": _tokens(cfg, w, seed=i)}
        out = graphed(params, batch)
        assert _equal(out, plain(params, batch))
        held.append(_held_bytes(graphed))
    out_bytes = sum(t.untyped_storage().nbytes() for t in tree_leaves(out))
    assert len(graphed.graphs) == len(widths) and len(graphed.outputs) == 1
    assert all(c.out is out for c in graphed.graphs.values())
    tok_bytes = [B * w * 8 for w in widths]
    assert held[:len(widths)] == [out_bytes + sum(tok_bytes[:i + 1])
                                  for i in range(len(widths))]
    assert held[len(widths):] == [held[len(widths) - 1]] * 3
    assert stand_ins.pools == [POOL] * len(widths)


@pytest.mark.parametrize("arch", ["gemma3-1b", "granite-moe-3b-a800m",
                                  "falcon-mamba-7b", "recurrentgemma-9b",
                                  "whisper-small", "paligemma-3b"])
def test_prefill_outputs_have_one_shape_a_batch_size(arch):
    """The prefill's logits and cache have the same shapes and dtypes at
    every prompt width of a batch size (the cache is at ``s_max``), so one
    set of static outputs serves every width of ``GraphedPrefill``."""
    cfg = get_config(arch).smoke()
    gen = torch.Generator().manual_seed(0)
    params = transformer.init_params(cfg, gen, device="cpu")
    step = model.make_prefill_step(cfg, 40 + cfg.num_prefix_tokens)
    shapes = {serve_loop._shapes(step(params, _batch(cfg, gen, S)))
              for S in (5, 17)}
    assert len(shapes) == 1
