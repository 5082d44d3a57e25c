"""The port's continuous-batching engine (teochat_torch/serve/engine.py) on the CPU.

Against the JAX package, on the same fp32 weights (the tiny TEOChat, its
lm_head scaled x40 for a well-separated argmax) and the same cache and
state, made from numpy seeds:
- `llama_forward`'s modes the engine needs (a 1-row prefill at a row offset
  of a wider cache, chunked-prefill pieces that attend the cache, logits
  mode "none", a decode step over the request rows of a cache with pool
  rows, each row's live length capped by `kv_len`) against JAX's
  `llama_forward` (1e-4 relative; the cache rows written and those left);
- `_prefill_slot`, `_prefill_chunk_write` + `_prefill_slot_tail`,
  `_prefill_slot_from_prefix` (its row copy, then the suffix) and
  `_decode_chunk` against JAX's programs of the same names: tokens exact,
  the cache and the state within 1e-5 (an inactive row's trash slot, which
  nothing reads, aside);
- `BatchEngine`'s greedy tokens against JAX's `TEOChat.generate`, request
  by request.
Then the behaviour of tests/test_engine.py and tests/test_engine_prefix.py
(all but the speculative and adaptive cases, which
tests/test_torch_engine_spec.py holds), held to the port's own
`TEOChat.generate`; a decode step with every host read patched to raise;
the chat server in engine mode (concurrent HTTP requests, SSE, /stats, a
session turn that holds the engine's device lock); what is not ported
raising and naming its ROADMAP item.
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from teochat_tpu.config import GenerationConfig as JaxGenerationConfig
from teochat_tpu.config import tiny_test_config
from teochat_tpu.models import fusion as jax_fusion
from teochat_tpu.models import llama as jax_llama
from teochat_tpu.models import teochat as jax_teochat
from teochat_tpu.serve import engine as jax_engine
from teochat_torch.checkpoint.bridge import to_torch
from teochat_torch.config import GenerationConfig
from teochat_torch.constants import IMAGE_TOKEN_INDEX
from teochat_torch.data.processing import ImageProcessor
from teochat_torch.models import fusion as torch_fusion
from teochat_torch.models import generation as torch_gen
from teochat_torch.models import llama as torch_llama
from teochat_torch.models import teochat as torch_teochat
from teochat_torch.serve import engine as engine_mod
from teochat_torch.serve import server as server_mod
from teochat_torch.serve.chat import Chat
from teochat_torch.serve.engine import BatchEngine
from teochat_torch.serve.server import ChatServer
from tests.test_eval_e2e import MockTokenizer
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

RTOL, ATOL = 1e-4, 1e-5  # the forward's logits against JAX's
STATE_TOL = 1e-5  # cache rows and state against JAX's programs
SYSTEM = list(range(40, 60))  # a 20-token shared "system prompt"
GREEDY = dict(temperature=0.0, do_sample=False, stop_strings=())


def _gen(n):
    return GenerationConfig(max_new_tokens=n, **GREEDY)


@pytest.fixture(scope="module")
def params():
    """The tiny fp32 TEOChat's config and weights (numpy)."""
    cfg = dataclasses.replace(tiny_test_config(vocab_size=128), dtype="float32")
    p = jax_teochat.init_teochat(jax.random.PRNGKey(7), cfg)
    llm = dict(p["llm"])
    llm["lm_head"] = {"kernel": llm["lm_head"]["kernel"] * 40.0}
    return cfg, jax.tree.map(np.asarray, {**p, "llm": llm})


@pytest.fixture(scope="module")
def model(params):
    cfg, p = params
    return torch_teochat.TEOChat(cfg, to_torch(p, "cpu"), tokenizer=MockTokenizer())


@pytest.fixture(scope="module")
def jax_model(params):
    cfg, p = params
    return jax_teochat.TEOChat(cfg, p, tokenizer=MockTokenizer())


def _prompts(n, seed=7):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        ids = [1, 5 + i, IMAGE_TOKEN_INDEX] + list(rng.randint(4, 100, 3 + i))
        out.append((ids, rng.randn(1, 3, 28, 28).astype(np.float32)))
    return out


def _submit_all(engine, prompts, gens):
    results = [None] * len(prompts)

    def run(i):
        results[i] = engine.submit(prompts[i][0], prompts[i][1], gens[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return results


@pytest.fixture
def engine_of(model):
    """A started BatchEngine over the tiny model, shut down after the test."""
    made = []

    def make(**kw):
        made.append(BatchEngine(model, **kw).start())
        return made[-1]

    yield make
    for e in made:
        e.shutdown()


# ------------------------------------------------------ against the JAX package


def _jax_forward(cfg, **options):
    """JAX's cached llama_forward, jitted, with `options` fixed."""
    def fn(params, k, v, emb, pos, kv_mask, last_index):
        return jax_llama.llama_forward(
            params, cfg, emb, position_ids=pos, cache=jax_llama.KVCache(k=k, v=v),
            write_slots=pos, kv_mask=kv_mask, last_index=last_index, **options)

    return jax.jit(fn)


def _forward_case(mode, rs, cfg, rows=3, t=24):
    """One call's inputs: (cache K, V [L, rows, T, Hkv, D], emb, positions,
    JAX kwargs, torch kwargs)."""
    shape = (cfg.num_layers, rows, t, cfg.num_kv_heads, cfg.head_dim)
    k, v = (rs.randn(*shape).astype(np.float32) for _ in range(2))
    d = cfg.hidden_size
    if mode == "row_offset_prefill":  # a 1-row monolithic prefill into row 1
        emb = rs.randn(1, 16, d).astype(np.float32)
        pos = np.arange(16, dtype=np.int32)[None]
        jkw = dict(logits_mode="last", cache_row_offset=1)
        tkw = dict(logits_mode="last", cache_row_offset=1, last_index=torch.tensor([11]))
        return k, v, emb, pos, dict(jkw, last_index=np.array([11], np.int32)), tkw
    if mode == "attend_cache_piece":  # a later piece over row 2's first 8 slots, no logits
        emb = rs.randn(1, 8, d).astype(np.float32)
        pos = np.arange(8, 16, dtype=np.int32)[None]
        kw = dict(logits_mode="none", cache_row_offset=2, prefill_start=8, attend_cache=True)
        return k, v, emb, pos, kw, dict(kw)
    if mode == "attend_cache_tail":  # the last piece, its pad queries past the prompt
        emb = rs.randn(1, 8, d).astype(np.float32)
        pos = np.arange(16, 24, dtype=np.int32)[None]
        kw = dict(logits_mode="last", cache_row_offset=0, prefill_start=16, attend_cache=True)
        return (k, v, emb, pos, dict(kw, last_index=np.array([4], np.int32)),
                dict(kw, last_index=torch.tensor([4])))
    # a decode step over rows [0, 2) of a 3-row cache (a pool row after them):
    # row 0 active at slot 13, row 1 inactive, writing at the trash slot and
    # attending its slot 0 alone (kv_len 1; JAX's mask slot < kv_len)
    emb = rs.randn(2, 1, d).astype(np.float32)
    pos = np.array([[13], [t - 1]], np.int32)
    kv_len = np.array([14, 1], np.int32)
    kv_mask = np.arange(t)[None, :] < kv_len[:, None]
    return (k, v, emb, pos, dict(logits_mode="last", kv_mask=kv_mask),
            dict(logits_mode="last", kv_len=torch.from_numpy(kv_len)))


@pytest.mark.parametrize("mode", ["row_offset_prefill", "attend_cache_piece",
                                  "attend_cache_tail", "decode_over_wider_cache"])
def test_cached_forward_modes_match_jax(params, mode):
    cfg, p = params
    llm = p["llm"]
    rs = np.random.RandomState(3)
    k, v, emb, pos, jkw, tkw = _forward_case(mode, rs, cfg.llm)
    kv_mask = jkw.pop("kv_mask", None)
    last_index = jkw.pop("last_index", None)
    fn = _jax_forward(cfg.llm, **jkw)
    want, want_cache = fn(llm, jnp.asarray(k), jnp.asarray(v), jnp.asarray(emb),
                          jnp.asarray(pos), None if kv_mask is None else jnp.asarray(kv_mask),
                          None if last_index is None else jnp.asarray(last_index))
    cache = torch_llama.KVCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()))
    got = torch_llama.llama_forward(to_torch(llm, "cpu"), cfg.llm, torch.from_numpy(emb),
                                    position_ids=torch.from_numpy(pos), cache=cache,
                                    write_slots=torch.from_numpy(pos), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    rows = {"row_offset_prefill": [1], "attend_cache_piece": [2], "attend_cache_tail": [0],
            "decode_over_wider_cache": [0, 1]}[mode]
    for got_c, want_c, before in ((cache.k, want_cache.k, k), (cache.v, want_cache.v, v)):
        np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=RTOL,
                                   atol=STATE_TOL)
        untouched = [r for r in range(k.shape[1]) if r not in rows]
        np.testing.assert_array_equal(got_c.numpy()[:, untouched], before[:, untouched])


def test_forward_raises_for_what_is_not_ported(params):
    cfg, p = params
    tllm = to_torch(p["llm"], "cpu")
    cache = torch_llama.init_cache(cfg.llm, 2, 8, dtype=torch.float32, device="cpu")
    x, one = torch.zeros(1, 1, cfg.llm.hidden_size), torch.zeros(1, 1, dtype=torch.long)
    with pytest.raises(ValueError, match="outside a cache"):
        torch_llama.llama_forward(tllm, cfg.llm, x, position_ids=one, cache=cache,
                                  write_slots=one, cache_row_offset=2)
    with pytest.raises(NotImplementedError, match="not a prefix"):  # a kv_mask that is not one
        torch_llama.llama_forward(tllm, cfg.llm, x, position_ids=one, cache=cache,
                                  write_slots=one, kv_mask=torch.tensor([[0, 1] * 4]).bool())


MAX_SLOTS, MAX_LEN, POOL = 3, 48, 1


def _state_pair(rs, cfg, active, positions, last_tokens, hist_len):
    """The same engine state in both packages: (JAX dict, EngineState)."""
    cache_shape = (cfg.num_layers, MAX_SLOTS + POOL, MAX_LEN, cfg.num_kv_heads, cfg.head_dim)
    k, v = (rs.randn(*cache_shape).astype(np.float32) for _ in range(2))
    hist = np.full((MAX_SLOTS, MAX_LEN), -1, np.int32)
    for r, n in enumerate(hist_len):
        hist[r, :n] = rs.randint(4, 100, n)
    fields = dict(last_tokens=np.asarray(last_tokens, np.int32),
                  positions=np.asarray(positions, np.int32), active=np.asarray(active, bool),
                  temperature=np.array([0.0, 0.7, 0.0], np.float32),
                  do_sample=np.zeros(MAX_SLOTS, bool), hist=hist,
                  hist_len=np.asarray(hist_len, np.int32),
                  adapter=np.full(MAX_SLOTS, -1, np.int32))
    jstate = jax_engine._init_engine_state(MAX_SLOTS, MAX_LEN, jax.random.PRNGKey(0))
    jstate.update({n: jnp.asarray(a) for n, a in fields.items()})
    jcache = jax_llama.KVCache(k=jnp.asarray(k), v=jnp.asarray(v))
    tcache = torch_llama.KVCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()))
    tstate = engine_mod._init_engine_state(tcache, MAX_SLOTS, MAX_LEN, 4)
    for n, a in fields.items():
        getattr(tstate, n).copy_(torch.from_numpy(a))
    return jcache, jstate, tcache, tstate


def _assert_state(jcache, jstate, tcache, tstate, skip_trash_rows=()):
    jk, jv = np.array(jcache.k), np.array(jcache.v)
    tk, tv = tcache.k.numpy().copy(), tcache.v.numpy().copy()
    for r in skip_trash_rows:  # an inactive row's trash slot: never read
        for a in (jk, jv, tk, tv):
            a[:, r, -1] = 0.0
    np.testing.assert_allclose(tk, jk, rtol=0, atol=STATE_TOL)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=STATE_TOL)
    for n in ("last_tokens", "positions", "active", "temperature", "do_sample", "hist",
              "hist_len", "adapter"):
        np.testing.assert_array_equal(getattr(tstate, n).numpy(), np.asarray(jstate[n]), n)


def _plan_pair(ids, tpf, pad_to):
    kw = dict(tokens_per_frame=tpf, max_length=MAX_LEN, pad_to=pad_to)
    return jax_fusion.build_fusion_plan([ids], **kw), torch_fusion.build_fusion_plan([ids], **kw)


@pytest.mark.parametrize("program", ["prefill_slot", "chunked_prefill", "prefill_from_prefix",
                                     "decode_chunk"])
def test_engine_programs_match_jax(params, model, jax_model, program):
    cfg, p = params
    jllm, tllm = p["llm"], model.params["llm"]
    rs = np.random.RandomState(11)
    tpf = model.tokens_per_frame
    frames = rs.randn(1, 3, 28, 28).astype(np.float32)
    jvis, tvis = jax_model.encode(frames), model.encode(frames)
    hist_row = np.full((MAX_LEN,), -1, np.int32)
    if program == "decode_chunk":
        jcache, jstate, tcache, tstate = _state_pair(rs, cfg.llm, [True, False, True],
                                                     [9, 5, 20], [17, 33, 54], [6, 3, 12])
        # an EOS the port's first row emits inside the chunk (it goes inactive)
        probe = engine_mod._init_engine_state(
            torch_llama.KVCache(tcache.k.clone(), tcache.v.clone()), MAX_SLOTS, MAX_LEN, 4)
        for n in ("last_tokens", "positions", "active", "temperature", "do_sample", "hist",
                  "hist_len"):
            getattr(probe, n).copy_(getattr(tstate, n))
        kw = dict(chunk=4, pad_id=0, emb_dtype=torch.float32)
        eos = int(engine_mod._decode_chunk(tllm, cfg.llm, probe, eos_id=-1, **kw)[0, 1])
        want, jcache, jstate = jax_engine._decode_chunk(jllm, jcache, jstate, cfg.llm, 4, eos, 0)
        got = engine_mod._decode_chunk(tllm, cfg.llm, tstate, eos_id=eos, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert not tstate.active[0] and bool(tstate.active[2])
        _assert_state(jcache, jstate, tcache, tstate, skip_trash_rows=(0, 1))
        return
    jcache, jstate, tcache, tstate = _state_pair(rs, cfg.llm, [True, False, False], [9, 0, 0],
                                                 [17, 0, 0], [6, 0, 0])
    sample = dict(temperature=0.0, do_sample=False)
    jsample = (jnp.asarray([0.0], jnp.float32), jnp.asarray([False]))
    if program == "prefill_slot":
        ids = [1, 9, IMAGE_TOKEN_INDEX] + list(rs.randint(4, 100, 5))
        hist_row[:len(ids)] = ids
        jplan, tplan = _plan_pair(ids, tpf, 16)
        want, jcache, jstate = jax_engine._prefill_slot(
            jllm, jcache, jstate, cfg.llm, jplan, jvis, jnp.asarray(1, jnp.int32), *jsample,
            jnp.asarray(hist_row), jnp.asarray(len(ids), jnp.int32), jnp.asarray([-1], jnp.int32))
        got = engine_mod._prefill_slot(tllm, tcache, tstate, cfg.llm, tplan, tvis, 1, **sample,
                                       hist_row=hist_row, hist_n=len(ids), adapter=-1)
    elif program == "chunked_prefill":  # 20 fused tokens in pieces of 8 into row 2
        ids = [1, IMAGE_TOKEN_INDEX] + list(rs.randint(4, 100, 15))
        hist_row[:len(ids)] = ids
        jplan, tplan = _plan_pair(ids, tpf, 24)
        jemb = jax_teochat.fuse_embeds(jllm, jplan, jvis)
        temb = torch_teochat.fuse_embeds(tllm, tplan, tvis)
        for i in range(2):
            jcache = jax_engine._prefill_chunk_write(
                jllm, jcache, cfg.llm, jemb[:, 8 * i:8 * i + 8],
                jnp.arange(8 * i, 8 * i + 8, dtype=jnp.int32)[None], jnp.asarray(2, jnp.int32),
                jnp.asarray([-1], jnp.int32))
            engine_mod._prefill_chunk_write(tllm, tcache, cfg.llm, temb[:, 8 * i:8 * i + 8],
                                            8 * i, 2, -1)
        want, jcache, jstate = jax_engine._prefill_slot_tail(
            jllm, jcache, jstate, cfg.llm, jemb[:, 16:24],
            jnp.arange(16, 24, dtype=jnp.int32)[None], jnp.asarray(20, jnp.int32),
            jnp.asarray([3], jnp.int32), jnp.asarray(2, jnp.int32), *jsample,
            jnp.asarray(hist_row), jnp.asarray(len(ids), jnp.int32), jnp.asarray([-1], jnp.int32))
        got = engine_mod._prefill_slot_tail(tllm, tcache, tstate, cfg.llm, temb[:, 16:24], 16,
                                            20, 3, 2, **sample, hist_row=hist_row,
                                            hist_n=len(ids), adapter=-1)
    else:  # a hit on pool row 3 (random K/V stand in for a pooled prefix): 12 reused slots
        ids = list(rs.randint(4, 100, 12)) + [IMAGE_TOKEN_INDEX] + list(rs.randint(4, 100, 4))
        hist_row[:len(ids)] = ids
        jplan, tplan = _plan_pair(ids, tpf, 32)
        fused = len(ids) + tpf - 1
        want, jcache, jstate = jax_engine._prefill_slot_from_prefix(
            jllm, jcache, jstate, cfg.llm, jplan, jvis, jnp.asarray(3, jnp.int32),
            jnp.asarray(1, jnp.int32), jnp.asarray(12, jnp.int32), jnp.asarray(fused, jnp.int32),
            32, 16, *jsample, jnp.asarray(hist_row), jnp.asarray(len(ids), jnp.int32),
            jnp.asarray([-1], jnp.int32))
        got = engine_mod._prefill_slot_from_prefix(
            tllm, tcache, tstate, cfg.llm, tplan, tvis, 3, 1, 12, fused, 32, 16, **sample,
            hist_row=hist_row, hist_n=len(ids), adapter=-1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_state(jcache, jstate, tcache, tstate)


def test_engine_greedy_tokens_are_jax_generates(model, jax_model, engine_of):
    """Greedy requests through the port's engine, admitted together, give
    JAX's single-request TEOChat.generate tokens, request by request."""
    prompts = _prompts(3) + [([1, 9, 12, 4, 30, 31], None)]
    gens = [_gen(n) for n in (6, 9, 4, 7)]
    want = [jax_model.generate([ids], fr, JaxGenerationConfig(max_new_tokens=g.max_new_tokens,
                                                              **GREEDY))[0]
            for (ids, fr), g in zip(prompts, gens)]
    engine = engine_of(max_slots=4, max_len=64, chunk=2)
    got = _submit_all(engine, prompts, gens)
    assert got == [list(map(int, w)) for w in want]
    assert engine.stats["max_concurrent"] >= 2


# ------------------------------------ tests/test_engine.py's behaviour, port only


def test_engine_matches_single_request_greedy(model, engine_of):
    prompts = _prompts(3)
    expected = [model.generate([ids], fr, _gen(6))[0] for ids, fr in prompts]
    engine = engine_of(max_slots=4, max_len=64, chunk=2)
    assert _submit_all(engine, prompts, [_gen(6)] * 3) == expected
    assert engine.stats["requests"] == 3 and engine.stats["max_concurrent"] >= 2


def test_engine_rejects_oversized_prompt(model):
    engine = BatchEngine(model, max_slots=2, max_len=32, chunk=2)
    with pytest.raises(ValueError, match="exceeds engine max_len"):
        engine.submit([1] * 40, None, GenerationConfig(max_new_tokens=4))


def test_engine_submit_before_start_raises(model):
    engine = BatchEngine(model, max_slots=2, max_len=32, chunk=2)
    with pytest.raises(RuntimeError, match="start"):
        engine.submit([1, 2, 3], None, _gen(2))
    with pytest.raises(RuntimeError, match="start"):
        next(iter(engine.submit_stream([1, 2, 3], None, _gen(2))))


def test_engine_text_only_and_eos(model, engine_of):
    """Text-only prompts need no frames; EOS stops a row early."""
    ids = [1, 7, 8, 9]
    full = model.generate([ids], None, _gen(8))[0]
    engine = engine_of(max_slots=2, max_len=64, chunk=4)
    assert engine.submit(ids, None, _gen(8)) == full
    # a model whose EOS is a later greedy token (its first appearance) stops
    # there, inside a chunk
    j = next(j for j in range(1, len(full)) if full[j] not in full[:j])
    eos_model = torch_teochat.TEOChat(
        dataclasses.replace(model.cfg, llm=dataclasses.replace(model.cfg.llm,
                                                               eos_token_id=full[j])),
        model.params, tokenizer=model.tokenizer)
    eos_engine = BatchEngine(eos_model, max_slots=2, max_len=64, chunk=4).start()
    try:
        assert eos_engine.submit(ids, None, _gen(8)) == full[:j + 1]
    finally:
        eos_engine.shutdown()


def test_engine_submit_stream_matches_blocking(model, engine_of):
    ids = [1, 7, 8, 9]
    engine = engine_of(max_slots=2, max_len=64, chunk=2)
    blocking = engine.submit(ids, None, _gen(6))
    chunks = list(engine.submit_stream(ids, None, _gen(6)))
    assert len(chunks) >= 2 and [t for c in chunks for t in c] == blocking


def test_engine_fatal_error_fails_requests(model, monkeypatch):
    """A crash in the decode chunk fails the requests in flight and queued,
    and refuses new ones, instead of hanging their callers."""
    def boom(*a, **k):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(engine_mod, "_decode_chunk", boom)
    engine = BatchEngine(model, max_slots=2, max_len=64, chunk=2).start()
    try:
        with pytest.raises(RuntimeError, match="engine failed"):
            engine.submit([1, 9, 12, 4], None, _gen(6))
        with pytest.raises(RuntimeError, match="engine failed"):
            engine.submit([1, 2, 3], None, _gen(6))
    finally:
        engine.shutdown()


def test_engine_soak_slot_recycling(model, engine_of):
    """Many short requests through two slots: admission, freeing, the
    history's rewrite and the cache rows' reuse stay exact."""
    engine = engine_of(max_slots=2, max_len=96, chunk=2)
    prompts = [[1, 5 + (i % 5), 9, 4 + (i % 3)] for i in range(16)]  # prompt 15 repeats prompt 0
    expected = {}
    for i, ids in enumerate(prompts):
        out = engine.submit(ids, None, _gen(4))
        assert expected.setdefault(tuple(ids), out) == out, f"request {i} diverged"
    assert engine.stats["requests"] == 16


def test_engine_stop_string_and_slot_reuse(model, engine_of):
    """A host-decided stop under the depth-1 pipeline: the chunk in flight
    decodes the stopped row on, its tokens are dropped, and the freed slot
    serves the next request exactly."""
    (ids, frames), (ids2, frames2) = _prompts(2)
    full = model.generate([ids], frames, _gen(8))[0]
    assert len(full) >= 3
    stop = model.tokenizer.decode([full[1]])
    expected = []
    for t in full:
        expected.append(t)
        if stop in model.tokenizer.decode(expected):
            break
    assert len(expected) < len(full)
    gen_stop = GenerationConfig(max_new_tokens=8, temperature=0.0, do_sample=False,
                                stop_strings=(stop,))
    engine = engine_of(max_slots=1, max_len=64, chunk=4)
    assert engine.submit(ids, frames, gen_stop) == expected
    assert engine.submit(ids2, frames2, _gen(8)) == model.generate([ids2], frames2, _gen(8))[0]
    assert engine.submit(ids, frames, gen_stop) == expected


def test_engine_max_new_tokens_one(model, engine_of):
    ids, frames = _prompts(1)[0]
    ref = model.generate([ids], frames, _gen(1))[0]
    engine = engine_of(max_slots=2, max_len=64, chunk=4)
    for _ in range(3):  # slot reuse after deferred finishes
        assert engine.submit(ids, frames, _gen(1)) == ref and len(ref) == 1


def test_engine_mixed_lengths_with_single_token_rows(model, engine_of):
    prompts = _prompts(3)
    gens = [_gen(n) for n in (1, 9, 5)]
    refs = [model.generate([ids], fr, g)[0] for (ids, fr), g in zip(prompts, gens)]
    engine = engine_of(max_slots=3, max_len=64, chunk=4)
    assert _submit_all(engine, prompts, gens) == refs


def _long_prompts(n, seed, extra=5, base=20):
    rng = np.random.RandomState(seed)
    return [([1, IMAGE_TOKEN_INDEX] + list(rng.randint(4, 100, base + extra * i)),
             rng.randn(1, 3, 28, 28).astype(np.float32)) for i in range(n)]


def test_engine_chunked_prefill_matches_single(model, engine_of):
    prompts = _long_prompts(3, 3)
    expected = [model.generate([ids], fr, _gen(6))[0] for ids, fr in prompts]
    engine = engine_of(max_slots=4, max_len=96, chunk=2, prefill_chunk=8)
    assert _submit_all(engine, prompts, [_gen(6)] * 3) == expected


def test_engine_chunked_prefill_mixed_with_short(model, engine_of):
    """A long chunked admission does not disturb a short request decoding in
    another slot, nor the other way round."""
    rng = np.random.RandomState(9)
    prompts = [([1, 5, IMAGE_TOKEN_INDEX, 7, 8], rng.randn(1, 3, 28, 28).astype(np.float32)),
               ([1, IMAGE_TOKEN_INDEX] + list(rng.randint(4, 100, 40)),
                rng.randn(1, 3, 28, 28).astype(np.float32))]
    expected = [model.generate([ids], fr, _gen(8))[0] for ids, fr in prompts]
    engine = engine_of(max_slots=2, max_len=128, chunk=2, prefill_chunk=8)
    assert _submit_all(engine, prompts, [_gen(8)] * 2) == expected


def test_engine_chunked_prefill_short_prompt_uses_plain_path(model, engine_of, monkeypatch):
    calls = []
    monkeypatch.setattr(engine_mod, "_prefill_chunk_write",
                        lambda *a, **k: calls.append(1))
    ids = [1, 5, 9]
    engine = engine_of(max_slots=2, max_len=64, chunk=2, prefill_chunk=64)
    assert engine.submit(ids, None, _gen(4)) == model.generate([ids], None, _gen(4))[0]
    assert not calls


def _chat(model):
    return Chat(model_bundle=(model.tokenizer, model, ImageProcessor(size=28)))


def _http(port, path, payload=None, raw=False):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method="GET" if payload is None else "POST",
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        if raw:
            return r.status, r.headers["Content-Type"], [line.decode().strip() for line in r]
        return r.status, json.loads(r.read())


@pytest.fixture
def engine_server(model, engine_of):
    engine = engine_of(max_slots=4, max_len=128, chunk=2)
    srv = ChatServer(_chat(model), host="127.0.0.1", port=0, engine=engine).start_background()
    yield srv, srv._httpd.server_address[1]
    srv.shutdown()


def test_http_concurrent_streams(engine_server):
    """Four concurrent HTTP requests through the engine all complete, with
    rows decoding together; /stats reports the engine's counters."""
    srv, port = engine_server
    results = [None] * 4

    def post(i):
        results[i] = _http(port, "/generate", {"prompt": f"Describe scene {i}.", "images": [],
                                               "temperature": 0.0, "max_new_tokens": 6})

    threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert all(r is not None and r[0] == 200 and isinstance(r[1]["response"], str)
               for r in results), results
    code, stats = _http(port, "/stats")
    assert code == 200 and stats["mode"] == "continuous_batching"
    assert stats["requests"] == 4 and stats["max_concurrent"] >= 2


def test_http_sse_stream(engine_server, model):
    """A streamed request: one event a decode chunk, then [DONE]; its tokens
    are a blocking request's. A streamed session request is refused."""
    srv, port = engine_server
    payload = {"prompt": "Describe.", "images": [], "temperature": 0.0, "max_new_tokens": 6}
    code, ctype, lines = _http(port, "/generate", {**payload, "stream": True}, raw=True)
    events = [line[len("data: "):] for line in lines if line.startswith("data: ")]
    assert code == 200 and ctype == "text/event-stream" and events[-1] == "[DONE]"
    payloads = [json.loads(e) for e in events[:-1]]
    assert len(payloads) >= 2
    streamed = [t for e in payloads for t in e["token_ids"]]
    input_ids, pixel_values, gen = srv._engine_request(payload)
    assert streamed == srv.engine.submit(input_ids, pixel_values, gen)
    assert payloads[-1]["text"] == srv._response_text(streamed)
    code, out = _http_error(port, {**payload, "stream": True, "session_id": "s"})
    assert code == 400 and "stateless" in out["error"]


def _http_error(port, payload):
    try:
        return _http(port, "/generate", payload)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_session_turns_hold_the_engine_device_lock(engine_server, model, monkeypatch):
    """In engine mode a session turn runs on the server's worker thread with
    the engine's device lock held, so it never runs inside the engine's
    scheduling iteration (on the card, a capture there fails if another
    thread allocates); sent while stateless requests decode, it is
    answered as a server without an engine answers it."""
    srv, port = engine_server
    engine = srv.engine
    inside, seen = threading.Event(), []
    schedule = engine._schedule

    def scheduling(first):
        inside.set()
        try:
            return schedule(first)
        finally:
            inside.clear()

    from teochat_torch.serve import session as session_mod
    turn = session_mod.ChatSession.generate

    def checked(self, *a, **k):
        seen.append((engine.device_lock._is_owned(), inside.is_set()))
        return turn(self, *a, **k)

    turn_payload = {"prompt": "What is here?", "images": [], "temperature": 0.0,
                    "max_new_tokens": 5, "session_id": "s"}
    plain = ChatServer(_chat(model), host="127.0.0.1", port=0).start_background()
    try:
        want = _http(plain._httpd.server_address[1], "/generate", turn_payload)
    finally:
        plain.shutdown()
    monkeypatch.setattr(engine, "_schedule", scheduling)
    monkeypatch.setattr(session_mod.ChatSession, "generate", checked)
    results = {}
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, _http(
        port, "/generate", {"prompt": f"Scene {i}.", "images": [], "temperature": 0.0,
                            "max_new_tokens": 8}))) for i in range(3)]
    threads.append(threading.Thread(target=lambda: results.__setitem__(
        "turn", _http(port, "/generate", turn_payload))))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert results["turn"] == want and all(results[i][0] == 200 for i in range(3))
    assert seen and all(owned and not during for owned, during in seen), seen


# ------------------------------- tests/test_engine_prefix.py's behaviour, port only


def _shared_prefix_prompts(n):
    rng = np.random.RandomState(3)
    return [([1] + SYSTEM + [IMAGE_TOKEN_INDEX] + list(rng.randint(4, 100, 2 + i)),
             rng.randn(1, 3, 28, 28).astype(np.float32)) for i in range(n)]


def test_prefix_hits_are_token_exact(model, engine_of):
    prompts = _shared_prefix_prompts(3)
    plain = engine_of(max_slots=2, max_len=96, chunk=2)
    expected = [plain.submit(ids, fr, _gen(6)) for ids, fr in prompts]
    engine = engine_of(max_slots=2, max_len=96, chunk=2, prefix_cache_slots=2,
                       prefix_min_tokens=8)
    assert [engine.submit(ids, fr, _gen(6)) for ids, fr in prompts] == expected
    assert engine.stats["prefix_hits"] == 2
    assert engine.stats["prefix_tokens_saved"] == 2 * (1 + len(SYSTEM))


def test_prefix_hits_concurrent(model, engine_of):
    prompts = _shared_prefix_prompts(4)
    expected = [model.generate([ids], fr, _gen(5))[0] for ids, fr in prompts]
    engine = engine_of(max_slots=4, max_len=96, chunk=2, prefix_cache_slots=2,
                       prefix_min_tokens=8)
    assert _submit_all(engine, prompts, [_gen(5)] * 4) == expected


def test_text_only_exact_repeat(model, engine_of):
    ids = [1] + SYSTEM + [7, 9, 11]
    expected = model.generate([ids], None, _gen(5))[0]
    engine = engine_of(max_slots=2, max_len=96, chunk=2, prefix_cache_slots=1,
                       prefix_min_tokens=8)
    assert engine.submit(ids, None, _gen(5)) == expected
    assert engine.submit(ids, None, _gen(5)) == expected
    assert engine.stats["prefix_hits"] == 1
    assert engine.stats["prefix_tokens_saved"] == len(ids) - 1  # all but the last token


def test_lru_eviction(model, engine_of):
    a = [1] + SYSTEM + [7, 9]
    b = [1] + list(range(70, 90)) + [8, 10]
    ea, eb = (model.generate([x], None, _gen(3))[0] for x in (a, b))
    engine = engine_of(max_slots=2, max_len=96, chunk=2, prefix_cache_slots=1,
                       prefix_min_tokens=8)
    assert engine.submit(a, None, _gen(3)) == ea  # store a
    assert engine.submit(b, None, _gen(3)) == eb  # evict a, store b
    assert engine.stats["prefix_hits"] == 0
    assert engine.submit(b, None, _gen(3)) == eb  # hit b
    assert engine.stats["prefix_hits"] == 1
    assert engine.submit(a, None, _gen(3)) == ea  # a miss (evicted), stored again
    assert engine.stats["prefix_hits"] == 1
    assert [e["key"] for e in engine._prefix_entries] == [tuple(a)]


def test_short_prefix_not_pooled(model, engine_of):
    ids = [1, 5, 9, IMAGE_TOKEN_INDEX, 12]  # a 3-token text run
    frames = np.random.RandomState(0).randn(1, 3, 28, 28).astype(np.float32)
    engine = engine_of(max_slots=2, max_len=96, chunk=2, prefix_cache_slots=1,
                       prefix_min_tokens=8)
    engine.submit(ids, frames, _gen(3))
    engine.submit(ids, frames, _gen(3))
    assert engine.stats["prefix_hits"] == 0 and engine._prefix_entries == []


def test_prefix_with_chunked_prefill(model, engine_of):
    prompts = _shared_prefix_prompts(3)
    expected = [model.generate([ids], fr, _gen(5))[0] for ids, fr in prompts]
    engine = engine_of(max_slots=2, max_len=96, chunk=2, prefill_chunk=8,
                       prefix_cache_slots=2, prefix_min_tokens=8)
    assert [engine.submit(ids, fr, _gen(5)) for ids, fr in prompts] == expected
    assert engine.stats["prefix_hits"] == 2


def test_longer_run_extends_pool(model, engine_of):
    """A hit whose run extends the matched entry replaces it in place."""
    turn1 = [1] + SYSTEM + [7, 9]
    turn2 = turn1 + [13, 15, 17]
    e1, e2 = (model.generate([x], None, _gen(3))[0] for x in (turn1, turn2))
    engine = engine_of(max_slots=2, max_len=96, chunk=2, prefix_cache_slots=2,
                       prefix_min_tokens=8)
    assert engine.submit(turn1, None, _gen(3)) == e1
    assert engine.submit(turn2, None, _gen(3)) == e2
    assert engine.stats["prefix_hits"] == 1
    assert [e["plen"] for e in engine._prefix_entries] == [len(turn2)]
    assert engine.submit(turn1, None, _gen(3)) == e1
    assert engine.submit(turn2, None, _gen(3)) == e2
    assert engine.stats["prefix_hits"] == 3
    assert engine.stats["prefix_tokens_saved"] >= len(turn1) + len(turn1) - 1 + len(turn2) - 1


def test_divergent_tiny_tail_not_pooled(model, engine_of):
    base = [1] + SYSTEM
    prompts = [base + [60 + i, 90 + i] for i in range(3)]
    expected = [model.generate([ids], None, _gen(3))[0] for ids in prompts]
    engine = engine_of(max_slots=2, max_len=96, chunk=2, prefix_cache_slots=4,
                       prefix_min_tokens=8)
    assert [engine.submit(ids, None, _gen(3)) for ids in prompts] == expected
    assert engine.stats["prefix_hits"] == 2
    assert engine.stats["prefix_tokens_saved"] == 2 * len(base)
    assert len(engine._prefix_entries) == 1


# --------------------------------------------------------- graph safety, what raises


def test_a_decode_step_reads_nothing_back(model, monkeypatch):
    """One decode step with every method that copies a tensor's values to the
    host patched to raise (the guard of tests/test_torch_decode_graph.py):
    the step can be captured in a CUDA graph."""
    cfg = model.cfg.llm
    cache = torch_llama.init_cache(cfg, MAX_SLOTS + POOL, MAX_LEN, dtype=torch.float32,
                                   device="cpu")
    st = engine_mod._init_engine_state(cache, MAX_SLOTS, MAX_LEN, 4)
    st.active.copy_(torch.tensor([True, False, True]))
    st.positions.copy_(torch.tensor([5, 0, MAX_LEN + 3], dtype=torch.int32))  # one past the cache
    st.do_sample[2], st.temperature[2] = True, 0.8

    def refuse(*_a, **_k):
        raise AssertionError("a decode step read a tensor back to the host")

    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__",
                 "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    for _ in range(2):
        engine_mod._decode_step(model.params["llm"], cfg, st, st.generator, eos_id=-1, pad_id=0,
                                emb_dtype=torch.float32)
    monkeypatch.undo()
    assert int(st.col) == 2 and st.tokens[1, :2].eq(0).all()
    assert st.positions.tolist() == [7, 0, MAX_LEN + 5]


def test_engine_graph_entry_is_the_engines_own(model):
    """The engine's decode graph entry sits outside the session table: it
    is released by shutdown() and by clear_decode_graphs()."""
    cache = torch_llama.init_cache(model.cfg.llm, 2, 16, dtype=torch.float32, device="cpu")
    st = engine_mod._init_engine_state(cache, 2, 16, 2)
    entry = torch_gen.own_decode_graph(torch_gen.DecodeGraph(
        st, engine_mod._decode_step, model.params["llm"]["embed_tokens"]["embedding"],
        dict(eos_id=2, pad_id=0, emb_dtype=torch.float32), generator=st.generator))
    assert entry.generator is st.generator and entry not in torch_gen.decode_graphs()
    entry.graph, entry.launches = object(), {"K2": 1}  # stands in for a captured graph
    torch_gen.clear_decode_graphs()
    assert entry.graph is None and entry.launches == {}


def test_what_is_not_ported_raises(model, monkeypatch):
    # the speculative mode is ported: an engine with speculative_k is built
    # with its chunk buffers, and the server's flag reaches the device check
    engine = BatchEngine(model, max_slots=2, max_len=32, chunk=3, speculative_k=4)
    assert engine._state.spec_tokens.shape == (2, 3, 5)
    assert engine._state.spec_counts.shape == (2, 3)
    # the fp8 KV cache is ported: an e4m3 engine pools its rows in e4m3, and
    # a kv_dtype other than the model's or e4m3 still raises
    engine = BatchEngine(model, max_slots=2, max_len=32, prefix_cache_slots=1,
                         kv_dtype="float8_e4m3fn")
    assert engine.cache.k.dtype == engine.cache.v.dtype == torch.float8_e4m3fn
    assert engine.cache.k.shape[1] == 3  # two request rows and the prefix pool's row
    for unsupported in ("bfloat16", "int8", torch.float16):
        with pytest.raises(ValueError, match="kv_dtype"):
            BatchEngine(model, kv_dtype=unsupported)
    # multi-LoRA is ported (tests/test_torch_multi_lora.py): over params
    # without stacked adapters an adapter is refused, -1 is the base model
    engine = BatchEngine(model, max_slots=1, max_len=32)
    with pytest.raises(ValueError, match="stacked LoRA"):
        engine._make_request([1, 2], None, _gen(2), adapter=0)
    assert engine._make_request([1, 2], None, _gen(2), adapter=-1).adapter == -1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server_mod.main(["--model_path", "unused", "--continuous_batching",
                         "--speculative_k", "4"])


def test_server_main_builds_an_engine_only_on_a_card(monkeypatch):
    """`--continuous_batching` without a card raises before the checkpoint
    is read: the engine never runs on the CPU in its place."""
    from teochat_torch.serve import chat as chat_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(chat_mod, "Chat", lambda *a, **k: pytest.fail("Chat was built"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server_mod.main(["--model_path", "unused", "--continuous_batching", "--max_slots", "8",
                         "--prefill_chunk", "256", "--prefix_cache_slots", "2"])
