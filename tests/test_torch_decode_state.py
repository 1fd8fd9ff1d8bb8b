"""The served decode step's state, port against the reference.

``ServeCache.cur_pos`` is a () int32 tensor on the tokens' device, as the
reference's is a () int32 array, and the decode step never reads it on
the host: that is what lets ``Server`` on the card replay the step from
a CUDA graph (``runtime.serve_loop.GraphedDecode``), the port's
counterpart of the reference's ``jax.jit``.  Decoding past ``s_max``
gives the reference's result, whose ``dynamic_update_slice`` clamps the
write to the last slot.  ``Server`` on the CPU keeps the plain step, and
an error of the graph path ends the run instead of re-prefilling.

Tolerance as in ``tests/test_torch_lm_archs.py``: in f32 the logits
agree within ``F32_LOGIT_TOL`` = 1e-4 of max |logit|, the caches within
the same share of their largest magnitude."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jget_config
from repro.models.lm import transformer as jtransformer
from repro.runtime.serve_loop import Request as JRequest
from repro.runtime.serve_loop import Server as JServer
from repro_torch.configs import get_config
from repro_torch.models.lm import model, transformer
from repro_torch.runtime.serve_loop import (GraphedDecode, GraphError,
                                            Request, Server)
from repro_torch.tree import tree_leaves
from repro_torch.weights import from_jax_params

F32_LOGIT_TOL = 1e-4
B = 2


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-6)


def _cut(cfg, ns):
    if ns is None:
        return cfg
    return dataclasses.replace(cfg, segments=tuple(
        dataclasses.replace(s, n=n) for s, n in zip(cfg.segments, ns)))


def _f32_params(jc, seed=0):
    jparams = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32),
        jtransformer.init_params(jc, jax.random.PRNGKey(seed)))
    return jparams, from_jax_params(jparams, "cpu")


@pytest.mark.parametrize("arch,cut", [("gemma3-1b", None),
                                      ("recurrentgemma-9b", (1, 1))])
def test_decode_past_s_max(arch, cut):
    """Two steps in the cache, then two at positions s_max and s_max + 1:
    logits, caches and positions as the reference's."""
    jc, tc = _cut(jget_config(arch).smoke(), cut), \
        _cut(get_config(arch).smoke(), cut)
    jparams, params = _f32_params(jc)
    rng = np.random.default_rng(3)
    S, s_max = 12, 14
    toks = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    jlog, jcache = jax.jit(lambda p, t: jtransformer.prefill(jc, p, t, s_max))(
        jparams, jnp.asarray(toks))
    log, cache = transformer.prefill(tc, params, torch.from_numpy(toks).long(),
                                     s_max)
    assert _rel(log, jlog) <= F32_LOGIT_TOL
    jdec = jax.jit(lambda p, t, c: jtransformer.decode(jc, p, t, c))
    for step in range(4):
        tok = rng.integers(0, jc.vocab, (B, 1)).astype(np.int32)
        jlog, jcache = jdec(jparams, jnp.asarray(tok), jcache)
        log, cache = transformer.decode(tc, params,
                                        torch.from_numpy(tok).long(), cache)
        assert int(cache.cur_pos) == int(jcache.cur_pos) == S + step + 1
        assert _rel(log, jlog) <= F32_LOGIT_TOL, (step, _rel(log, jlog))
        for a, b in zip(tree_leaves(cache.entries),
                        jax.tree_util.tree_leaves(jcache.entries), strict=True):
            assert _rel(a, b) <= F32_LOGIT_TOL, step


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
            raise AssertionError("the decode step read a value on the host")
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
def test_cur_pos_is_a_device_scalar_never_read_on_the_host(arch, monkeypatch):
    """After the prefill and after each decode step ``cur_pos`` is a ()
    int32 tensor on the tokens' device, advanced in place; each step runs
    under a dispatch mode that fails on a read of a value on the host."""
    cfg = get_config(arch).smoke()
    gen = torch.Generator().manual_seed(0)
    params = transformer.init_params(cfg, gen, device="cpu")
    S = 10
    batch = _batch(cfg, gen, S)
    s_max = S + cfg.num_prefix_tokens + 3
    logits, cache = model.make_prefill_step(cfg, s_max)(params, batch)
    decode = model.make_decode_step(cfg)
    pos = cache.cur_pos
    for step in range(4):           # the last one past s_max
        assert isinstance(pos, torch.Tensor) and pos.shape == () \
            and pos.dtype == torch.int32 \
            and pos.device == batch["tokens"].device
        assert int(pos) == S + cfg.num_prefix_tokens + step
        tok = torch.argmax(logits[:, -1:], dim=-1)
        with _NoHostReads(monkeypatch):
            logits, cache = decode(params, tok, cache)
        assert cache.cur_pos is pos
        assert torch.isfinite(logits).all()
    assert int(pos) == s_max + 1


def test_server_on_the_cpu_keeps_the_plain_step():
    """No graph object on the CPU; on a two-layer cut (f32) the server's
    tokens are the reference server's."""
    jc = _cut(jget_config("gemma3-1b").smoke(), (2,))
    tc = _cut(get_config("gemma3-1b").smoke(), (2,))
    jparams, params = _f32_params(jc)
    server = Server(tc, params, max_batch=2, s_max=32)
    assert server.graph is None and not isinstance(server.decode, GraphedDecode)
    jserver = JServer(jc, jparams, max_batch=2, s_max=32)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jc.vocab, n).astype(np.int32) for n in (7, 12, 5)]
    reqs = [Request(i, torch.from_numpy(p), max_new=6)
            for i, p in enumerate(prompts)]
    jreqs = [JRequest(i, jnp.asarray(p), max_new=6)
             for i, p in enumerate(prompts)]
    stats, jstats = server.serve(reqs), jserver.serve(jreqs)
    assert stats.decode_steps == jstats.decode_steps and stats.retries == 0
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]


class _FailingGraph:
    """A stand-in for ``GraphedDecode`` whose capture fails as PyTorch's
    does (a ``RuntimeError``) or whose replay fails as ``GraphedDecode``
    reports it."""

    def __init__(self, step, fail_at):
        self.step, self.fail_at = step, fail_at

    def capture(self, params, token, cache):
        if self.fail_at == "capture":
            raise RuntimeError("capture failed")

    def __call__(self, params, token, cache):
        if self.fail_at == "replay":
            raise GraphError("replay failed")
        return self.step(params, token, cache)


@pytest.mark.parametrize("fail_at", ["capture", "replay"])
def test_graph_errors_end_the_run(fail_at):
    """A capture or replay error is no decode fault: it ends the run, and
    the server does not re-prefill (a ``RuntimeError`` of the step would
    be retried: ``tests/test_torch_serve.py``)."""
    cfg = get_config("stablelm-1.6b").smoke()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    server = Server(cfg, params, max_batch=2, s_max=32)
    server.graph = server.decode = _FailingGraph(server.decode, fail_at)
    prefills = []
    pre = server.prefill
    server.prefill = lambda p, b: prefills.append(1) or pre(p, b)
    with pytest.raises((RuntimeError, GraphError), match=f"{fail_at} failed"):
        server.serve([Request(0, torch.arange(5), max_new=3)])
    assert len(prefills) == 1


def test_graphed_decode_keys_and_parameters():
    """A graph a (batch, s_max), as jit's cache is keyed by shapes; a call
    with other parameters than the graph's is refused (both checked
    before anything runs on a card)."""
    cfg = get_config("gemma3-1b").smoke()
    gen = torch.Generator().manual_seed(0)
    params = transformer.init_params(cfg, gen, device="cpu")
    toks = torch.randint(0, cfg.vocab, (B, 6), generator=gen)
    caches = {s_max: transformer.prefill(cfg, params, toks, s_max)[1]
              for s_max in (16, 24)}
    tok = toks[:, :1]
    key = GraphedDecode.key
    assert key(tok, caches[16]) == key(tok.clone(), caches[16])
    assert key(tok, caches[16]) != key(tok, caches[24])
    assert key(tok, caches[16]) != key(toks[:1, :1], caches[16])
    other = transformer.tree_map(torch.clone, params)
    with pytest.raises(ValueError, match="parameters other"):
        GraphedDecode(cfg, params).capture(other, tok, caches[16])
