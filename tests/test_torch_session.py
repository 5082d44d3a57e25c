"""The port's incremental KV sessions against the JAX package, on the CPU.

K2m's plain version and its walk (`ops/decode_attention.py`) against JAX's
`xla_attention` under the mask `slot <= q_slot & kv_mask` of the JAX cached
path; `llama_forward(spec_verify=True, kv_mask=...)` against JAX's (logits,
and the cache at the written slots); `prefill_full`, `prefill_suffix` (fed
the JAX cache carried across as numpy) and `decode_with_cache` against
JAX's; then the port's `ChatSession` against JAX's over three turns (text
only, with frames, and a new frame that sorts before the committed ones),
tokens, stats and the committed cache slots, and again with speculative_k=3
(tokens, stats with spec_steps and spec_accepted, committed slots).
Everything is fp32, on the tiny model of test_torch_decode_graph.py (lm_head
x40, so reduction-order noise cannot flip an argmax), at RTOL, ATOL = 1e-4,
1e-5 as in test_torch_llama.py. One JAX model serves the module, and its programs are
few (the XLA CPU compiler survives a few hundred a process).
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from teochat_tpu.config import GenerationConfig, tiny_test_config
from teochat_tpu.constants import IMAGE_TOKEN_INDEX as IMG
from teochat_tpu.models import generation as jax_gen
from teochat_tpu.models import llama as jax_llama
from teochat_tpu.models import teochat as jax_teochat
from teochat_tpu.ops.attention import xla_attention
from teochat_tpu.serve.session import ChatSession as JaxChatSession
from teochat_torch.checkpoint.bridge import to_torch
from teochat_torch.models import generation as torch_gen
from teochat_torch.models import llama as torch_llama
from teochat_torch.models import teochat as torch_teochat
from teochat_torch.ops import decode_attention as dec_mod
from teochat_torch.serve.session import ChatSession

RTOL, ATOL = 1e-4, 1e-5
MAX_LEN = 512


@pytest.fixture(scope="module")
def models():
    """(JAX TEOChat, the port's TEOChat) on the same fp32 weights."""
    cfg = dataclasses.replace(tiny_test_config(vocab_size=128), dtype="float32")
    params = jax_teochat.init_teochat(jax.random.PRNGKey(7), cfg)
    llm = dict(params["llm"])
    llm["lm_head"] = {"kernel": llm["lm_head"]["kernel"] * 40.0}  # well-separated argmax
    params = jax.tree.map(np.asarray, {**params, "llm": llm})
    return (jax_teochat.TEOChat(cfg, params),
            torch_teochat.TEOChat(cfg, to_torch(params, "cpu")))


# ---------------------------------------------------------------- K2m


def _jax_cached_attention(q, k, v, q_slots, kv_mask):
    """The JAX cached path's attention (llama.py:329-336) on [B, T, Hkv, D] slabs."""
    t = k.shape[1]
    mask = np.arange(t)[None, None, :] <= q_slots[:, :, None]
    mask = mask & kv_mask[:, None, :]
    return np.asarray(xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    mask=jnp.asarray(mask)))


def _suffix_against_jax(b, s, h, hkv, d, t, start, live, seed, sms=132):
    """K2m's plain version and walk (for `sms` SMs) against the JAX masked
    attention on a session's suffix: S queries at slots start, start + 1,
    ... with the last ones padded to the trash slot t - 1, kv_mask the
    prefix start + live."""
    rs = np.random.RandomState(seed)
    q = rs.randn(b, s, h, d).astype(np.float32)
    k = rs.randn(b, t, hkv, d).astype(np.float32)
    v = rs.randn(b, t, hkv, d).astype(np.float32)
    valid = np.arange(s)[None, :] < live[:, None]
    q_slots = np.where(valid, start + np.arange(s)[None, :], t - 1).astype(np.int32)
    kv_mask = np.arange(t)[None, :] < (start + live)[:, None]
    want = _jax_cached_attention(q, k, v, q_slots, kv_mask)

    lengths = dec_mod.query_lengths(torch.from_numpy(q_slots), torch.from_numpy(kv_mask))
    np.testing.assert_array_equal(  # padded queries see the whole prefix
        lengths.numpy(), np.where(valid, q_slots + 1, start + live[:, None]))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plain = dec_mod.decode_attention_multi(tq, tk.transpose(1, 2), tv.transpose(1, 2), lengths)
    walk = dec_mod.decode_attention_multi_schedule(tq, tk.transpose(1, 2), tv.transpose(1, 2),
                                                   lengths, sms=sms)
    np.testing.assert_allclose(plain.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(walk.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("h,hkv,d,t,start", [
    (4, 4, 64, 80, 0),  # a start of 0: the suffix is the whole conversation
    (4, 2, 64, 100, 31),  # group 2; the suffix straddles the first chunk's end
    (8, 2, 128, 130, 64),  # group 4, D 128; the suffix starts on a chunk's edge
    (16, 1, 64, 90, 33),  # group 16: a row tile of one query's 16 heads
])
def test_multi_query_attention_matches_jax(h, hkv, d, t, start):
    """K2m's plain version and its walk against the JAX masked attention on a
    session's suffix: S queries at slots start, start + 1, ... with the last
    ones padded to the trash slot t - 1, kv_mask the prefix start + live."""
    _suffix_against_jax(2, 37, h, hkv, d, t, start, np.array([37, 30]), h * 100 + start)


@pytest.mark.parametrize("s,h,hkv,d,t,start,sms,plan", [
    (2, 4, 4, 64, 1100, 1000, 132, (1, 4, 5)),  # a verify block (k = 1) over a long cache
    (9, 8, 2, 128, 900, 880, 132, (1, 3, 5)),  # k = 8, group 4
    (9, 4, 2, 64, 700, "edge", 132, (1, 2, 6)),  # lengths ragged across the split's edge
    (37, 4, 4, 64, 600, 500, 16, (4, 2, 5)),  # 64-row tiles, two splits (a card of 16 SMs)
    (20, 4, 4, 64, 600, 300, 16, (2, 2, 5)),  # 32-row tiles; the suffix across the split's edge
])
def test_multi_query_walk_splits_match_jax(s, h, hkv, d, t, start, sms, plan):
    """K2m's walk where it splits the slots across blocks (`multi_plan`'s
    pick for these shapes and `sms` SMs: row_warps, splits, split_chunks),
    merging the splits' partials in split order, against the JAX masked
    attention; row 1 of the batch has fewer live queries."""
    b = 2
    assert dec_mod.multi_plan(b, s, h, hkv, t, sms) == plan
    if start == "edge":  # the first live lengths below the second split's first slot, the rest past it
        start = plan[2] * dec_mod.MULTI_CHUNK - 4
    _suffix_against_jax(b, s, h, hkv, d, t, start, np.array([s, s // 2]), s * 10 + h, sms)


def test_multi_query_walk_writes_a_query_of_length_zero_as_zero():
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(*shape).astype(np.float32))
               for shape in ((1, 3, 4, 64), (1, 4, 40, 64), (1, 4, 40, 64)))
    lengths = torch.tensor([[0, 1, 40]], dtype=torch.int32)
    walk = dec_mod.decode_attention_multi_schedule(q, k, v, lengths, sms=132)
    plain = dec_mod.decode_attention_multi_plain(q, k, v, lengths)
    assert walk[0, 0].abs().sum() == 0
    torch.testing.assert_close(walk[0, 1:], plain[0, 1:], rtol=RTOL, atol=ATOL)


def test_query_lengths_refuses_a_mask_that_is_not_a_prefix():
    slots = torch.tensor([[2, 3]])
    assert dec_mod.query_lengths(slots).tolist() == [[3, 4]]
    with pytest.raises(NotImplementedError, match="prefix"):
        dec_mod.query_lengths(slots, torch.tensor([[True, False, True, True]]))


# ------------------------------------------------------- the cached forward


def _prefix_conversation(cfg, rs, t_max, start):
    """A cache whose first `start` slots hold a committed conversation (random
    K/V), and a suffix of 6 live queries padded to 8."""
    shape = (cfg.num_layers, 2, t_max, cfg.num_kv_heads, cfg.head_dim)
    k0 = rs.randn(*shape).astype(np.float32)
    v0 = rs.randn(*shape).astype(np.float32)
    emb = rs.randn(2, 8, cfg.hidden_size).astype(np.float32)
    live = np.array([6, 3], np.int32)
    mask = np.arange(8)[None, :] < live[:, None]
    pos = np.where(mask, np.arange(8)[None, :], 0).astype(np.int32)
    return k0, v0, emb, live, mask, pos


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_spec_verify_forward_matches_jax(kv_heads):
    """llama_forward(spec_verify=True, kv_mask=...) over a committed cache:
    the logits, and the cache at every written slot."""
    cfg = dataclasses.replace(tiny_test_config().llm, num_kv_heads=kv_heads)
    params = jax.tree.map(np.asarray, jax_llama.init_llama(jax.random.PRNGKey(5), cfg))
    rs = np.random.RandomState(kv_heads)
    t_max, start = 24, np.array([9, 14], np.int32)
    k0, v0, emb, live, mask, pos = _prefix_conversation(cfg, rs, t_max, start)
    abs_pos = (start[:, None] + pos).astype(np.int32)
    slots = np.where(mask, abs_pos, t_max - 1).astype(np.int32)
    kv_mask = np.arange(t_max)[None, :] < (start + live)[:, None]
    logits, cache = jax_llama.llama_forward(
        params, cfg, jnp.asarray(emb), position_ids=jnp.asarray(abs_pos),
        cache=jax_llama.KVCache(k=jnp.asarray(k0), v=jnp.asarray(v0)),
        write_slots=jnp.asarray(slots), kv_mask=jnp.asarray(kv_mask), logits_mode="all",
        spec_verify=True)

    tcache = torch_llama.KVCache(k=torch.from_numpy(k0.copy()), v=torch.from_numpy(v0.copy()))
    got = torch_llama.llama_forward(
        to_torch(params, "cpu"), cfg, torch.from_numpy(emb),
        position_ids=torch.from_numpy(abs_pos), cache=tcache, write_slots=torch.from_numpy(slots),
        kv_mask=torch.from_numpy(kv_mask), spec_verify=True)
    np.testing.assert_allclose(got.numpy()[mask], np.asarray(logits)[mask], rtol=RTOL, atol=ATOL)
    for row in range(2):  # the committed slots and the written ones (not the trash slot)
        kept = slice(0, int(start[row] + live[row]))
        for got_c, want_c in ((tcache.k, cache.k), (tcache.v, cache.v)):
            np.testing.assert_allclose(got_c[:, row, kept].numpy(), np.asarray(want_c)[:, row, kept],
                                       rtol=RTOL, atol=ATOL)


def _suffix_plan(model, ids):
    """(embeds, seq_lens, attention_mask, position_ids) as numpy for a
    right-padded suffix of text ids (no frames)."""
    from teochat_tpu.models import fusion as jax_fusion

    plan = jax_fusion.build_fusion_plan([ids], tokens_per_frame=model.tokens_per_frame,
                                        max_length=MAX_LEN, pad_to=16)
    vision = jnp.zeros((1, model.tokens_per_frame, model.cfg.llm.hidden_size), jnp.float32)
    emb = np.asarray(jax_teochat.multimodal_embeds(model.params, model.cfg, plan, vision))
    return emb, np.asarray(plan.seq_lens), np.asarray(plan.attention_mask), \
        np.asarray(plan.position_ids)


def test_prefill_and_decode_with_cache_match_jax(models):
    """prefill_full, then prefill_suffix fed the JAX cache carried across as
    numpy, then decode_with_cache on it: logits, cache slots and tokens."""
    jmodel, tmodel = models
    cfg = jmodel.cfg.llm
    jparams, tparams = jmodel.params["llm"], tmodel.params["llm"]
    first, second = [1, 5, 9, 4, 7, 11], [13, 8, 6, 21]
    stop = jax_gen.StopSpec(keyword_ids=jnp.zeros((1, 1), jnp.int32),
                            keyword_lens=jnp.zeros((1,), jnp.int32),
                            eos_id=jnp.asarray(cfg.eos_token_id, jnp.int32))
    tstop = torch_gen.StopSpec(keyword_ids=np.zeros((1, 1), np.int32),
                               keyword_lens=np.zeros((1,), np.int32), eos_id=cfg.eos_token_id)

    def t(a):
        return torch.from_numpy(np.array(a))

    emb, lens, mask, pos = _suffix_plan(jmodel, first)
    jlogits, jcache = jax_gen.prefill_full(
        jparams, cfg, jax_llama.init_cache(cfg, 1, MAX_LEN, dtype=jnp.float32), jnp.asarray(emb),
        jnp.asarray(lens), jnp.asarray(mask), jnp.asarray(pos))
    tcache = torch_llama.init_cache(cfg, 1, MAX_LEN, dtype=torch.float32, device="cpu")
    tlogits, tcache = torch_gen.prefill_full(tparams, cfg, tcache, t(emb), t(lens), t(mask), t(pos))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL)
    n = len(first)
    np.testing.assert_allclose(tcache.k[:, :, :n].numpy(), np.asarray(jcache.k)[:, :, :n],
                               rtol=RTOL, atol=ATOL)

    # the suffix over the JAX cache, carried across as numpy
    emb, lens, mask, pos = _suffix_plan(jmodel, second)
    start = np.array([n], np.int32)
    carried = torch_llama.KVCache(k=t(np.array(jcache.k)), v=t(np.array(jcache.v)))
    jlogits, jcache = jax_gen.prefill_suffix(
        jparams, cfg, jcache, jnp.asarray(emb), jnp.asarray(start), jnp.asarray(lens),
        jnp.asarray(mask), jnp.asarray(pos))
    tlogits, carried = torch_gen.prefill_suffix(tparams, cfg, carried, t(emb), t(start), t(lens),
                                                t(mask), t(pos))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL)
    n2 = n + len(second)
    for got_c, want_c in ((carried.k, jcache.k), (carried.v, jcache.v)):
        np.testing.assert_allclose(got_c[:, :, :n2].numpy(), np.asarray(want_c)[:, :, :n2],
                                   rtol=RTOL, atol=ATOL)

    # decode on from the suffix's logits over the same caches
    jtok, jn, jcache = jax_gen.decode_with_cache(
        jparams, cfg, jcache, jlogits, jnp.asarray(start + lens), stop, jax.random.PRNGKey(0),
        max_new_tokens=7, pad_id=cfg.pad_token_id)
    ttok, tn, carried = torch_gen.decode_with_cache(
        tparams, cfg, carried, tlogits, t(start + lens), tstop, torch.Generator().manual_seed(0),
        max_new_tokens=7, pad_id=cfg.pad_token_id)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    n3 = n2 + int(jn[0]) - 1  # every generated token's K/V but the last one's
    for got_c, want_c in ((carried.k, jcache.k), (carried.v, jcache.v)):
        np.testing.assert_allclose(got_c[:, :, :n3].numpy(), np.asarray(want_c)[:, :, :n3],
                                   rtol=RTOL, atol=ATOL)


def test_a_graph_entry_over_a_session_cache_lives_as_long_as_the_cache(models):
    """decode_with_cache's entry is keyed by the caller's cache and holds it
    weakly: the entry goes when the cache is dropped, and evicting entries
    never frees a live cache (bookkeeping only; no capture on the CPU)."""
    _, tmodel = models
    cfg, params = tmodel.cfg.llm, tmodel.params["llm"]
    step_kw = dict(temperature=0.0, do_sample=False, top_p=1.0, pad_id=0,
                   emb_dtype=torch.float32)
    torch_gen.clear_decode_graphs()
    try:
        cache = torch_llama.init_cache(cfg, 1, 40, dtype=torch.float32, device="cpu")
        entry = torch_gen._decode_graph(params, cfg, 1, 40, 8, (1, 1), torch.device("cpu"),
                                        step_kw, cache=cache)
        assert entry.state.cache is cache and entry.alive()
        again = torch_gen._decode_graph(params, cfg, 1, 40, 8, (1, 1), torch.device("cpu"),
                                        step_kw, cache=cache)
        assert again is entry
        other = torch_llama.init_cache(cfg, 1, 40, dtype=torch.float32, device="cpu")
        assert torch_gen._decode_graph(params, cfg, 1, 40, 8, (1, 1), torch.device("cpu"),
                                       step_kw, cache=other) is not entry
        owned = torch_gen._decode_graph(params, cfg, 1, 40, 8, (1, 1), torch.device("cpu"),
                                        step_kw)
        assert owned is not entry and owned.state.cache is not cache
        entry.state.cache = None  # as decode_with_cache leaves it
        cache.k.fill_(3.0)
        kept = [torch_llama.init_cache(cfg, 1, 40, dtype=torch.float32, device="cpu")
                for _ in range(torch_gen.MAX_DECODE_GRAPHS)]
        for c in kept:  # evicts the entry over `cache`
            torch_gen._decode_graph(params, cfg, 1, 40, 8, (1, 1), torch.device("cpu"), step_kw,
                                    cache=c)
        assert entry not in torch_gen.decode_graphs() and (cache.k == 3.0).all()
        last = torch_gen.decode_graphs()[-1]
        last.state.cache = None
        del kept, c
        gc.collect()
        assert last not in torch_gen.decode_graphs()
    finally:
        torch_gen.clear_decode_graphs()


# ------------------------------------------------------------ ChatSession


def _greedy(max_new=6):
    return GenerationConfig(max_new_tokens=max_new, do_sample=False, temperature=0.0,
                            stop_strings=())


def _committed(session, cache_k, cache_v):
    n = session._fused_len(session.kv_len)
    return np.asarray(cache_k)[:, :, :n], np.asarray(cache_v)[:, :, :n]


def test_session_matches_jax_over_three_turns(models):
    """Turn 1 text only (prefill_full), turn 2 with two frames (prefill_suffix
    over the committed turn), turn 3 with a new frame that sorts before the
    committed ones. Turns 1 and 2: the same tokens, stats and committed
    slots as the JAX session. Turn 3 keeps the ids of the committed prefix
    through both sentinels, but its first sentinel now stands for the new
    frame: the port re-prefills from that sentinel and gives the tokens of a
    stateless generate of the whole conversation (the JAX session reuses the
    old frames' K/V there); its committed slots are those of a fresh JAX
    session fed the whole conversation."""
    jmodel, tmodel = models
    jsession, session = JaxChatSession(jmodel, max_len=MAX_LEN), ChatSession(tmodel,
                                                                              max_len=MAX_LEN)
    gen = _greedy()
    rs = np.random.RandomState(0)
    f1, f2, new = (rs.randn(1, 3, 28, 28).astype(np.float32) for _ in range(3))

    convo = [1, 5, 9, 4, 7]
    want = jsession.generate(convo, None, gen)
    assert session.generate(convo, None, gen) == want
    assert session.stats == jsession.stats
    for got, ref in zip(_committed(session, session.cache.k, session.cache.v),
                        _committed(jsession, jsession.cache.k, jsession.cache.v)):
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)

    convo2 = convo + want + [13, IMG, 8, IMG, 6]
    frames2 = np.concatenate([f1, f2])
    want2 = jsession.generate(convo2, frames2, gen)
    assert session.generate(convo2, frames2, gen) == want2
    assert session.stats == jsession.stats
    assert session.stats["reused_tokens"] == len(convo) + len(want) - 1
    for got, ref in zip(_committed(session, session.cache.k, session.cache.v),
                        _committed(jsession, jsession.cache.k, jsession.cache.v)):
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)

    first_sent = convo2.index(IMG)
    second_sent = first_sent + 2
    convo3 = convo2[:second_sent + 1] + [14, IMG] + convo2[second_sent + 1:] + want2 + [11, 12]
    frames3 = np.concatenate([new, f1, f2])
    stateless = jmodel.generate([convo3], frames3, gen)[0]
    before = dict(session.stats)
    got3 = session.generate(convo3, frames3, gen)
    assert got3 == stateless == tmodel.generate([convo3], frames3, gen)[0]
    assert session.stats["reused_tokens"] - before["reused_tokens"] == first_sent
    assert session.stats["prefilled_tokens"] - before["prefilled_tokens"] == \
        len(convo3) - first_sent
    jsession.generate(convo3, frames3, gen)
    assert jsession.stats["reused_tokens"] - before["reused_tokens"] == second_sent + 1
    fresh = JaxChatSession(jmodel, max_len=MAX_LEN)
    assert fresh.generate(convo3, frames3, gen) == got3
    for got, ref in zip(_committed(session, session.cache.k, session.cache.v),
                        _committed(fresh, fresh.cache.k, fresh.cache.v)):
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert session.stats["turns"] == 3
    # the JAX session kept the old frames' K/V where the new frame now stands
    # (ROADMAP queue 3, F4): its committed slots are not the fresh session's
    stale = _committed(jsession, jsession.cache.k, jsession.cache.v)[0]
    ref = _committed(fresh, fresh.cache.k, fresh.cache.v)[0]
    assert stale.shape == ref.shape and not np.allclose(stale, ref, rtol=RTOL, atol=ATOL)


def test_session_divergent_history_and_reset(models):
    """Editing committed history re-prefills from the divergence (as JAX's);
    reset drops the cache, and the next turn starts from prefill_full."""
    jmodel, tmodel = models
    gen = _greedy(4)
    session = ChatSession(tmodel, max_len=MAX_LEN)
    assert session.cache is None  # allocated on the first turn
    out1 = session.generate([1, 5, 9, 4], None, gen)
    assert out1 and session.cache is not None
    edited = [1, 5, 3, 7]
    assert session.generate(edited, None, gen) == jmodel.generate([edited], None, gen)[0]
    assert session.stats["reused_tokens"] == 2
    session.reset()
    assert session.cache is None and session.tokens == [] and session.kv_len == 0
    assert session.generate(edited, None, gen) == jmodel.generate([edited], None, gen)[0]


def test_session_spec_matches_jax_over_three_turns(models):
    """Turns with speculative_k=3 (text; two frames over the committed turn;
    text again): the same tokens, stats (spec_steps and spec_accepted
    among them) and committed slots as the JAX session, and the tokens of
    turns without speculation."""
    jmodel, tmodel = models
    jsession, session = JaxChatSession(jmodel, max_len=MAX_LEN), ChatSession(tmodel,
                                                                              max_len=MAX_LEN)
    plain = ChatSession(tmodel, max_len=MAX_LEN)
    gen = dataclasses.replace(_greedy(8), speculative_k=3)
    rs = np.random.RandomState(4)
    frames = rs.randn(2, 3, 28, 28).astype(np.float32)
    convo = [1, 5, 9, 4, 7, 5, 9, 4]
    for turn in range(3):
        pixels = frames if turn else None
        want = jsession.generate(convo, pixels, gen)
        assert session.generate(convo, pixels, gen) == want, turn
        assert plain.generate(convo, pixels, _greedy(8)) == want, turn
        assert session.stats == jsession.stats, turn
        for got, ref in zip(_committed(session, session.cache.k, session.cache.v),
                            _committed(jsession, jsession.cache.k, jsession.cache.v)):
            np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
        convo = convo + want + ([13, IMG, 8, IMG, 6] if turn == 0 else [11, 12, 5, 9])
    assert session.stats["turns"] == 3 and session.stats["spec_steps"] >= 3
    assert session.stats["spec_accepted"] > 0


def test_session_refuses_what_it_cannot_hold_or_run(models):
    _, tmodel = models
    session = ChatSession(tmodel, max_len=32)
    with pytest.raises(ValueError, match="session cache full"):
        session.generate(list(range(1, 20)), None, _greedy(max_new=30))
    assert session.cache is None  # nothing allocated for a refused turn
    with pytest.raises(ValueError, match="needs 2 frames"):
        session.generate([1, IMG, 5, IMG], None, _greedy())
    # the cache-full check counts the spec_k draft slots: 19 + 10 + 1 fits 32,
    # 3 draft slots more do not
    spec = dataclasses.replace(_greedy(max_new=10), speculative_k=3)
    with pytest.raises(ValueError, match="3 draft slots"):
        session.generate(list(range(1, 20)), None, spec)
    assert session.cache is None
    assert len(session.generate(list(range(1, 20)), None, _greedy(max_new=10))) == 10
