"""The port's ``Server`` against the JAX package's ``Server`` on the same
prompts and parameters (the reference's ``init`` through
``from_jax_params``), including the decode-failure re-prefill path and
the left-padding the reference does.

Tokens.  The two servers' logits differ by bf16 rounding (see
``tests/test_torch_lm.py``: within ``LOGIT_TOL`` = 3e-2 of the largest
|logit|), so a greedy token may differ only where the reference's top-2
margin is within twice that bound.  Each request is compared token by
token: where the margin exceeds the bound the tokens must be equal, and
the logits must agree within the bound while the two continuations are
the same; after a token that differs within the margin the continuations
part, and the rest of that request is not compared."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jget_config
from repro.models.lm import transformer as jtransformer
from repro.runtime.serve_loop import Request as JRequest
from repro.runtime.serve_loop import Server as JServer
from repro_torch.configs import get_config
from repro_torch.runtime.serve_loop import Request, Server
from repro_torch.weights import from_jax_params

LOGIT_TOL = 3e-2


def _configs(arch, n_layers=None):
    jc, tc = jget_config(arch).smoke(), get_config(arch).smoke()
    if n_layers is not None:
        jc = dataclasses.replace(jc, segments=(dataclasses.replace(
            jc.segments[0], n=n_layers),))
        tc = dataclasses.replace(tc, segments=(dataclasses.replace(
            tc.segments[0], n=n_layers),))
    return jc, tc


def _record(server):
    """Wrap a server's steps to keep each call's last-position logits (f32
    numpy, one call per generated token) and each batch's first call."""
    calls, batches = [], []
    pre, dec, run = server.prefill, server.decode, server._run_batch

    def keep(out):
        calls.append(np.asarray(out[0][:, -1].float() if isinstance(
            out[0], torch.Tensor) else out[0][:, -1], np.float32))
        return out

    server.prefill = lambda params, batch: keep(pre(params, batch))
    server.decode = lambda params, tok, cache: keep(dec(params, tok, cache))

    def run_batch(live, stats):
        batches.append((list(live), len(calls)))
        return run(live, stats)

    server._run_batch = run_batch
    return calls, batches


def _serve_both(arch, n_layers, prompts, max_new, max_batch, s_max, hook=None):
    jc, tc = _configs(arch, n_layers)
    jparams = jtransformer.init_params(jc, jax.random.PRNGKey(0))
    params = from_jax_params(jparams, device="cpu")
    jserver = JServer(jc, jparams, max_batch=max_batch, s_max=s_max,
                      fault_hook=hook() if hook else None)
    server = Server(tc, params, max_batch=max_batch, s_max=s_max,
                    fault_hook=hook() if hook else None)
    jrec, rec = _record(jserver), _record(server)
    jreqs = [JRequest(i, jnp.asarray(p), max_new) for i, p in enumerate(prompts)]
    reqs = [Request(i, torch.from_numpy(p), max_new) for i, p in enumerate(prompts)]
    jstats, stats = jserver.serve(jreqs), server.serve(reqs)
    return (jreqs, jstats, jrec), (reqs, stats, rec)


def _compare(jside, side):
    (jreqs, jstats, (jcalls, jbatches)), (reqs, stats, (calls, batches)) = jside, side
    assert dataclasses.astuple(stats)[:4] == dataclasses.astuple(jstats)[:4]
    assert [c for _, c in batches] == [c for _, c in jbatches]
    checked = 0
    for (live, c0), (jlive, _) in zip(batches, jbatches):
        for i, (r, jr) in enumerate(zip(live, jlive)):
            assert r.rid == jr.rid and len(r.out_tokens) == len(jr.out_tokens)
            for j, (tok, jtok) in enumerate(zip(r.out_tokens, jr.out_tokens)):
                jl, tl = jcalls[c0 + j][i], calls[c0 + j][i]
                bound = LOGIT_TOL * np.abs(jl).max()
                assert np.abs(tl - jl).max() <= bound, (r.rid, j)
                top2 = np.sort(jl)[-2:]
                if top2[1] - top2[0] > 2 * bound:
                    assert tok == jtok, (r.rid, j)
                    checked += 1
                elif tok != jtok:
                    break           # the continuations part here
    return checked


def test_serve_gemma3_six_layers_past_the_window():
    """5 requests of 66-90 tokens (past the 64-token smoke window, a global
    layer in the stack), 8 new tokens each, batches of 2."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).astype(np.int32)
               for n in rng.integers(66, 91, 5)]
    jside, side = _serve_both("gemma3-1b", 6, prompts, max_new=8, max_batch=2,
                              s_max=128)
    assert side[1].served == 5 and side[1].prefills == 3
    assert all(len(r.out_tokens) == 8 for r in side[0])
    assert _compare(jside, side) > 0


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "starcoder2-3b", "gemma2-27b"])
def test_serve_smoke_archs(arch):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (8, 5, 11)]
    jside, side = _serve_both(arch, None, prompts, max_new=4, max_batch=2,
                              s_max=64)
    assert side[1].served == 3
    assert _compare(jside, side) > 0


def test_decode_failure_recovers_by_reprefill():
    """The reference's test: the second decode call fails; the server
    re-prefills with what it generated and goes on."""
    def hook():
        calls = {"n": 0}

        def fail_second(step):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("injected decode failure")
        return fail_second

    prompts = [np.arange(6, dtype=np.int32), np.arange(3, 12, dtype=np.int32)]
    jside, side = _serve_both("stablelm-1.6b", None, prompts, max_new=4,
                              max_batch=2, s_max=64, hook=hook)
    assert side[1].retries == 1 == jside[1].retries
    assert side[1].prefills == 2
    assert all(len(r.out_tokens) == 4 for r in side[0])
    _compare(jside, side)


def test_quirk_left_pad_with_zero():
    """Prompts are left-padded with token 0 to the widest of the batch, as
    the reference does; the pads are attended to, so a short prompt's
    logits depend on its batchmate's length."""
    jc, tc = _configs("gemma3-1b")
    jparams = jtransformer.init_params(jc, jax.random.PRNGKey(0))
    params = from_jax_params(jparams, device="cpu")
    short, long_ = np.array([5, 6, 7], np.int32), np.arange(1, 10, dtype=np.int32)
    server = Server(tc, params, max_batch=2, s_max=32)
    jserver = JServer(jc, jparams, max_batch=2, s_max=32)
    toks = server._pad_prompts([Request(0, torch.from_numpy(short)),
                                Request(1, torch.from_numpy(long_))])
    jtoks = jserver._pad_prompts([JRequest(0, jnp.asarray(short)),
                                  JRequest(1, jnp.asarray(long_))])
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    assert toks[0].tolist() == [0] * 6 + [5, 6, 7]
    alone, _ = server.prefill(params, {"tokens": toks[:1, 6:]})
    batched, _ = server.prefill(params, {"tokens": toks})
    assert not torch.equal(alone[0], batched[0])


def test_server_runs_on_the_parameters_device():
    cfg = get_config("stablelm-1.6b").smoke()
    from repro_torch.models.lm import transformer
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    server = Server(cfg, params, max_batch=2, s_max=32)
    assert server.device == torch.device("cpu")
    reqs = [Request(0, torch.arange(5), max_new=3)]
    stats = server.serve(reqs)
    assert stats.served == 1 and stats.decode_steps == 3
    assert all(0 <= t < cfg.vocab for t in reqs[0].out_tokens)
