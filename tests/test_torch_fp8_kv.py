"""The fp8 (e4m3) KV cache of the port against the JAX package's, on the CPU.

The JAX package offers `kv_dtype="float8_e4m3fn"` in `generate_tokens`,
`generate_tokens_spec`, `decode_with_cache(_spec)` (which embed in bf16 over
an e4m3 cache) and `BatchEngine`; the port offers it in the same places. Its
K2 / K2m kernels read the e4m3 slab in place on the card; here the plain
versions and the walks run, and each upcasts the slab exactly. Held to the
JAX package on the tiny fp32 model of test_torch_decode_graph.py (lm_head
x40, so reduction-order noise cannot flip an argmax), inputs from numpy
seeds, weights through the bridge:

- the cast: torch's and JAX's bf16 -> e4m3 agree byte for byte up to 464
  (which both round to ±448, ties to even); past it torch saturates to
  ±448 and JAX gives NaN (ROADMAP F5);
- K2's and K2m's plain versions and walks on an e4m3 slab equal themselves
  on `slab.to(bfloat16)` bit for bit, and JAX's attention over the upcast
  slab within 1e-4 relative, 1e-5 absolute (fp32: the two sum in another
  order), as tests/test_torch_decode_hopper.py and test_torch_session.py;
- the cache after a prefill and three decode steps: the bytes of JAX's
  `generate_tokens(kv_dtype="float8_e4m3fn")` cache, every one (no value
  reaches 464 here); `generate_tokens` and `generate_tokens_spec` the JAX
  tokens (and steps, accepted) exactly, and the first decode step's logits
  within 1e-4 of their largest |logit| (the same e4m3 bytes, fp32 sums in
  another order);
- `decode_with_cache(_spec)` over an e4m3 cache embed in bf16, and give
  JAX's tokens;
- the graph table keeps an e4m3 and a bf16 entry apart;
- `BatchEngine(kv_dtype="float8_e4m3fn")`, plain and speculative, gives the
  JAX engine's tokens with the same kv_dtype;
- the bench's e4m3 phases count the cache's bytes at one a value.

The JAX side is held to about twenty-five compilations.
"""

import dataclasses
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from teochat_tpu.config import GenerationConfig as JaxGenerationConfig
from teochat_tpu.config import tiny_test_config
from teochat_tpu.models import generation as jax_gen
from teochat_tpu.models import llama as jax_llama
from teochat_tpu.models import teochat as jax_teochat
from teochat_tpu.ops.attention import xla_attention
from teochat_tpu.ops.decode_attention import decode_attention as jax_decode
from teochat_tpu.serve import engine as jax_engine
from teochat_torch.bench import main as bench_main
from teochat_torch.checkpoint.bridge import to_torch
from teochat_torch.config import GenerationConfig
from teochat_torch.models import generation as torch_gen
from teochat_torch.models import llama as torch_llama
from teochat_torch.models import teochat as torch_teochat
from teochat_torch.ops import decode_attention as dec_mod
from teochat_torch.serve.engine import BatchEngine
from tests.test_eval_e2e import MockTokenizer
from tests.test_torch_engine import _prompts
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

E4M3 = torch.float8_e4m3fn
RTOL, ATOL = 1e-4, 1e-5  # fp32 attention against JAX's, as the K2 / K2m walk tests
LOGITS_REL = 1e-4  # a decode step's logits against JAX's, of the largest |logit|
S = 8
SEQ_LENS = [7, 4, 6]  # a ragged batch of 3, right-padded to S
NEVER = 127  # an EOS id the tiny model never picks in these runs


# ------------------------------------------------------------------ the cast

# values at and past e4m3's largest, 448: F5 in ROADMAP queue 3
F5_VALUES = [448.0, 464.0, 480.0, 1e4, -448.0, -464.0, -480.0, -1e4]


@pytest.mark.parametrize("x", F5_VALUES)
def test_cast_saturates_where_jax_gives_nan(x):
    """bf16 -> e4m3 at |x| >= 448: torch saturates to ±448 (0x7e / 0xfe);
    JAX's cast rounds 464, the midpoint to the NaN code, to ±448 (ties to
    even) and gives NaN (0x7f / 0xff) past it; eager and under jit alike."""
    ours = torch.tensor([x], dtype=torch.bfloat16).to(E4M3).view(torch.uint8).item()
    xj = jnp.asarray([x], jnp.bfloat16)
    theirs = {int(np.asarray(y).view(np.uint8)[0]) for y in (
        xj.astype(jnp.float8_e4m3fn), jax.jit(lambda a: a.astype(jnp.float8_e4m3fn))(xj))}
    sign = 0x80 if x < 0 else 0
    assert ours == 0x7e | sign
    assert theirs == {(0x7e if abs(x) <= 464.0 else 0x7f) | sign}


def test_cast_matches_jax_up_to_464():
    """20,000 bf16 values spread over e4m3's range and its subnormals: the
    same byte from both casts."""
    rs = np.random.RandomState(0)
    x = np.concatenate([rs.randn(10_000) * 40, rs.randn(5_000) * 2e-3,
                        rs.uniform(-464, 464, 5_000)]).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ours = xb.to(E4M3).view(torch.uint8).numpy()
    theirs = np.asarray(jnp.asarray(xb.float().numpy(), jnp.bfloat16)
                        .astype(jnp.float8_e4m3fn)).view(np.uint8)
    assert xb.abs().max().item() <= 464
    np.testing.assert_array_equal(ours, theirs)


# ------------------------------------------------------- K2 and K2m, plain


def _e4m3_slab(rs, *shape):
    """An e4m3 [B, Hkv, T, D] slab (a layer slab of the cache, transposed)
    and its exact bf16 upcast."""
    x = torch.from_numpy((rs.randn(*shape) * 2).astype(np.float32)).to(E4M3)
    return x, x.to(torch.bfloat16)


def _k2_case(seed, d=64, h=8, hkv=2, t=200):
    rs = np.random.RandomState(seed)
    c = dec_mod.CHUNK
    lens = torch.tensor([1, c - 1, c, c + 1, t], dtype=torch.int32)
    q = torch.from_numpy(rs.randn(len(lens), h, d).astype(np.float32))
    (k8, kb), (v8, vb) = _e4m3_slab(rs, len(lens), hkv, t, d), _e4m3_slab(rs, len(lens), hkv, t, d)
    return q, k8, v8, kb, vb, lens


@pytest.mark.parametrize("fn", ["decode_attention_plain", "decode_attention_split_schedule"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_k2_plain_and_walk_on_e4m3_are_the_upcast_slabs(fn, q_dtype):
    """K2's plain version and its split walk on an e4m3 slab: the bits they
    give on the slab upcast to bf16, and JAX's decode attention (the XLA
    path) over the upcast slab within RTOL / ATOL."""
    q, k8, v8, kb, vb, lens = _k2_case(0)
    q = q.to(q_dtype)
    got = getattr(dec_mod, fn)(q, k8, v8, lens)
    assert got.dtype == q_dtype
    assert torch.equal(got, getattr(dec_mod, fn)(q, kb, vb, lens))
    want = np.asarray(jax_decode(jnp.asarray(q.float().numpy()), jnp.asarray(kb.float().numpy()),
                                 jnp.asarray(vb.float().numpy()), jnp.asarray(lens.numpy()),
                                 impl="xla"))
    if q_dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    else:  # a bf16 query and output: the output's rounding, 2^-8 of |o| < 8
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=4e-2)


def _k2m_case(seed, b=2, s=9, h=8, hkv=2, d=64, t=300, start=200):
    """A session's suffix of S queries at slots start, start + 1, ... over an
    e4m3 slab; row 1's last queries padded to the trash slot."""
    rs = np.random.RandomState(seed)
    q = torch.from_numpy(rs.randn(b, s, h, d).astype(np.float32))
    (k8, kb), (v8, vb) = _e4m3_slab(rs, b, hkv, t, d), _e4m3_slab(rs, b, hkv, t, d)
    live = np.array([s, s // 2])
    valid = np.arange(s)[None, :] < live[:, None]
    q_slots = np.where(valid, start + np.arange(s)[None, :], t - 1).astype(np.int32)
    kv_mask = np.arange(t)[None, :] < (start + live)[:, None]
    lens = dec_mod.query_lengths(torch.from_numpy(q_slots), torch.from_numpy(kv_mask))
    return q, k8, v8, kb, vb, lens, q_slots, kv_mask


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_k2m_plain_on_e4m3_is_the_upcast_slab(q_dtype):
    """K2m's plain version on an e4m3 slab: the bits it gives on the slab
    upcast to q's dtype (JAX's `kl.astype(q.dtype)`; bf16 on the card, where
    P is then rounded to bf16 as JAX rounds it to V's dtype), and JAX's
    masked attention over that upcast within RTOL / ATOL (fp32), or the
    output's bf16 rounding (2^-8 of |o| < 8)."""
    q, k8, v8, _, _, lens, q_slots, kv_mask = _k2m_case(1)
    q = q.to(q_dtype)
    got = dec_mod.decode_attention_multi_plain(q, k8, v8, lens)
    assert got.dtype == q_dtype
    assert torch.equal(got, dec_mod.decode_attention_multi_plain(q, k8.to(q_dtype),
                                                                 v8.to(q_dtype), lens))
    t = k8.shape[2]
    mask = (np.arange(t)[None, None, :] <= q_slots[:, :, None]) & kv_mask[:, None, :]
    jd = jnp.float32 if q_dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(xla_attention(
        jnp.asarray(q.float().numpy(), jd), jnp.asarray(k8.float().transpose(1, 2).numpy(), jd),
        jnp.asarray(v8.float().transpose(1, 2).numpy(), jd), mask=jnp.asarray(mask)))
    tol = (RTOL, ATOL) if q_dtype == torch.float32 else (0, 4e-2)
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), rtol=tol[0],
                               atol=tol[1])


@pytest.mark.parametrize("sms", [132, 4])
def test_k2m_walk_on_e4m3_is_the_bf16_slabs(sms):
    """K2m's walk (one split; split across blocks on a card of 4 SMs) on an
    e4m3 slab: the bits it gives on the bf16 upcast, P rounded to bf16 both
    ways as the kernel rounds it (never to e4m3: with an fp32 V the bits
    differ), and JAX's masked attention over the upcast slab within 1e-2
    (JAX keeps P in fp32 here; 2^-9 of P alone reaches ~2e-3 of |o|)."""
    q, k8, v8, kb, vb, lens, q_slots, kv_mask = _k2m_case(1)
    got = dec_mod.decode_attention_multi_schedule(q, k8, v8, lens, sms=sms)
    assert torch.equal(got, dec_mod.decode_attention_multi_schedule(q, kb, vb, lens, sms=sms))
    assert not torch.equal(got, dec_mod.decode_attention_multi_schedule(q, k8, v8.float(), lens,
                                                                        sms=sms))
    t = k8.shape[2]
    mask = (np.arange(t)[None, None, :] <= q_slots[:, :, None]) & kv_mask[:, None, :]
    want = np.asarray(xla_attention(
        jnp.asarray(q.numpy()), jnp.asarray(kb.float().transpose(1, 2).numpy()),
        jnp.asarray(vb.float().transpose(1, 2).numpy()), mask=jnp.asarray(mask)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-2)


def test_llama_hands_the_slab_to_the_kernels_as_it_lies():
    """No upcast of the cache slab is left in the decoder: K2 and K2m read it
    in place, in bf16 or e4m3."""
    source = (Path(torch_llama.__file__)).read_text()
    assert ".to(q.dtype)" not in source
    assert len(re.findall(r"decode_attention(_multi)?\(\s*q(\[:, 0\])?, k_slab\.transpose\(1, 2\), "
                          r"v_slab\.transpose\(1, 2\)", source)) == 3


# ------------------------------------------------------------------ generate


@pytest.fixture(scope="module")
def model():
    """(TEOChatConfig, JAX llm params as numpy, torch llm params, the
    prompt's embeddings)."""
    cfg = dataclasses.replace(tiny_test_config(vocab_size=128), dtype="float32")
    params = jax_teochat.init_teochat(jax.random.PRNGKey(7), cfg)
    llm = dict(params["llm"])
    llm["lm_head"] = {"kernel": llm["lm_head"]["kernel"] * 40.0}  # well-separated argmax
    params = jax.tree.map(np.asarray, {**params, "llm": llm})
    rs = np.random.RandomState(11)
    ids = rs.randint(3, cfg.llm.vocab_size, size=(len(SEQ_LENS), S))
    ids[0, :6] = [5, 6, 7, 5, 6, 7]  # row 0 repeats itself: prompt-lookup drafts hit
    embeds = params["llm"]["embed_tokens"]["embedding"][ids].astype(np.float32)
    return cfg, params["llm"], to_torch(params, "cpu")["llm"], embeds, ids


def _prompt():
    seq_lens = np.array(SEQ_LENS, np.int32)
    mask = np.arange(S)[None, :] < seq_lens[:, None]
    pos = np.where(mask, np.arange(S)[None, :], 0).astype(np.int32)
    return seq_lens, mask, pos


def _jax_stop():
    return jax_gen.StopSpec(keyword_ids=jnp.zeros((1, 1), jnp.int32),
                            keyword_lens=jnp.zeros((1,), jnp.int32),
                            eos_id=jnp.asarray(NEVER, jnp.int32))


def _torch_stop():
    return torch_gen.StopSpec(keyword_ids=np.zeros((1, 1), np.int32),
                              keyword_lens=np.zeros((1,), np.int32), eos_id=NEVER)


@functools.lru_cache(maxsize=None)
def _jax_generate_with_cache(cfg, max_new: int, cache_len: int):
    """JAX's `generate_tokens` body with kv_dtype "float8_e4m3fn" (its
    prefill, then `_run_decode_loop`), returning the cache it drops, and the
    first decode step's logits (the step that feeds the first token)."""

    @jax.jit
    def run(params, embeds, seq_lens, mask, pos):
        b = embeds.shape[0]
        cache = jax_llama.init_cache(cfg, b, cache_len, dtype=jnp.float8_e4m3fn)
        slots = jnp.where(mask, pos, cache_len - 1)
        kv_mask = jnp.arange(cache_len)[None, :] < seq_lens[:, None]
        logits, cache = jax_gen.backend_forward(
            params, cfg, embeds, position_ids=pos, cache=cache, write_slots=slots,
            kv_mask=kv_mask, logits_mode="last", last_index=seq_lens - 1)
        tok0 = jnp.argmax(logits[:, -1], axis=-1)
        step_mask = jnp.arange(cache_len)[None, :] <= seq_lens[:, None]
        step_logits, _ = jax_gen.backend_forward(
            params, cfg, jax_gen.backend_embed(params, cfg, tok0[:, None], dtype=embeds.dtype),
            position_ids=seq_lens[:, None], cache=cache, write_slots=seq_lens[:, None],
            kv_mask=step_mask, logits_mode="last")
        tokens, n_gen, cache = jax_gen._run_decode_loop(
            params, cfg, cache, logits[:, -1], seq_lens, _jax_stop(), jax.random.PRNGKey(0),
            max_new_tokens=max_new, temperature=0.0, do_sample=False, top_p=1.0, pad_id=0,
            emb_dtype=embeds.dtype)
        return tokens, n_gen, cache.k, cache.v, step_logits[:, -1]

    return run


def _torch_generate(model, max_new, cache_len, kv_dtype="float8_e4m3fn"):
    cfg, _, tllm, embeds, _ = model
    seq_lens, mask, pos = _prompt()
    return torch_gen._generate_tokens(
        tllm, cfg.llm, torch.from_numpy(embeds), torch.from_numpy(seq_lens),
        torch.from_numpy(mask), torch.from_numpy(pos), _torch_stop(), torch.Generator(),
        max_new_tokens=max_new, cache_len=cache_len, temperature=0.0, do_sample=False,
        top_p=1.0, pad_id=0, graphed=False, kv_dtype=kv_dtype)


def test_cache_after_prefill_and_three_steps_has_jaxs_bytes(model):
    """Prefill and three decode writes (the port's run of 4 tokens feeds 3:
    its last token's forward is not run; JAX's run of 3 feeds 3): every byte
    of K and V is JAX's, and no value came near 464."""
    cfg, jllm, _, embeds, _ = model
    seq_lens, mask, pos = _prompt()
    cache_len = S + 8
    jtok, _, jk, jv, _ = _jax_generate_with_cache(cfg.llm, 3, cache_len)(
        jllm, jnp.asarray(embeds), jnp.asarray(seq_lens), jnp.asarray(mask), jnp.asarray(pos))
    tokens, _, state = _torch_generate(model, 4, cache_len)
    assert state.cache.dtype == E4M3
    np.testing.assert_array_equal(tokens.numpy()[:, :3], np.asarray(jtok))
    for ours, theirs in ((state.cache.k, jk), (state.cache.v, jv)):
        theirs = np.asarray(theirs)
        assert np.isfinite(theirs.astype(np.float32)).all()  # no NaN: nothing at 464 or past it
        np.testing.assert_array_equal(ours.view(torch.uint8).numpy(), theirs.view(np.uint8))
    for row, n in enumerate(SEQ_LENS):  # the three decode writes landed, nothing past them
        assert state.cache.k[:, row, n:n + 3].float().abs().sum() > 0
        assert not state.cache.k[:, row, max(n + 3, S):cache_len - 1].float().any()


def test_generate_tokens_e4m3_matches_jax(model):
    """`generate_tokens(kv_dtype="float8_e4m3fn")`: JAX's tokens and n_gen
    over 11 steps of a ragged batch exactly; the first decode step's logits
    (the port's run of 2 tokens keeps them) within LOGITS_REL of the largest."""
    cfg, jllm, tllm, embeds, _ = model
    seq_lens, mask, pos = _prompt()
    max_new = 11
    want_tokens, want_n = jax_gen.generate_tokens(
        jllm, cfg.llm, jnp.asarray(embeds), jnp.asarray(seq_lens), jnp.asarray(mask),
        jnp.asarray(pos), None, _jax_stop(), jax.random.PRNGKey(0), max_new_tokens=max_new,
        cache_len=S + max_new + 1, kv_dtype="float8_e4m3fn")
    tokens, n_gen = torch_gen.generate_tokens(
        tllm, cfg.llm, torch.from_numpy(embeds), torch.from_numpy(seq_lens),
        torch.from_numpy(mask), torch.from_numpy(pos), _torch_stop(), torch.Generator(),
        max_new_tokens=max_new, cache_len=S + max_new + 1, kv_dtype=E4M3)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
    np.testing.assert_array_equal(n_gen.numpy(), np.asarray(want_n))

    *_, want_logits = _jax_generate_with_cache(cfg.llm, 3, S + 8)(
        jllm, jnp.asarray(embeds), jnp.asarray(seq_lens), jnp.asarray(mask), jnp.asarray(pos))
    _, _, state = _torch_generate(model, 2, S + 8)
    want_logits = np.asarray(want_logits)
    np.testing.assert_allclose(state.logits.numpy(), want_logits, rtol=0,
                               atol=LOGITS_REL * np.abs(want_logits).max())
    # and the e4m3 cache is not the fp32 one: the steps' logits move
    _, _, fp32 = _torch_generate(model, 2, S + 8, kv_dtype=None)
    assert fp32.cache.dtype == torch.float32
    assert not torch.equal(fp32.logits, state.logits)


@pytest.mark.parametrize("k", [2, 4])
def test_generate_tokens_spec_e4m3_matches_jax(model, k):
    """`generate_tokens_spec(kv_dtype="float8_e4m3fn")`: JAX's tokens, n_gen,
    steps and accepted exactly (row 0 repeats itself, so drafts are
    accepted)."""
    cfg, jllm, tllm, embeds, ids = model
    seq_lens, mask, pos = _prompt()
    prompt_ids = np.where(mask, ids, -1).astype(np.int32)
    max_new = 10
    want = jax_gen.generate_tokens_spec(
        jllm, cfg.llm, jnp.asarray(embeds), jnp.asarray(seq_lens), jnp.asarray(mask),
        jnp.asarray(pos), jnp.asarray(prompt_ids), jnp.asarray(seq_lens), _jax_stop(),
        max_new_tokens=max_new, cache_len=S + max_new + k + 1, spec_k=k,
        kv_dtype="float8_e4m3fn")
    got = torch_gen.generate_tokens_spec(
        tllm, cfg.llm, torch.from_numpy(embeds), torch.from_numpy(seq_lens),
        torch.from_numpy(mask), torch.from_numpy(pos), prompt_ids, seq_lens, _torch_stop(),
        torch.Generator().manual_seed(0), max_new_tokens=max_new,
        cache_len=S + max_new + k + 1, spec_k=k, kv_dtype="float8_e4m3fn")
    for name, g, w in zip(("tokens", "n_gen", "steps", "accepted"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert int(got[3]) > 0


@pytest.mark.parametrize("spec", [False, True])
def test_decode_with_cache_embeds_bf16_over_an_e4m3_cache(model, monkeypatch, spec):
    """A session's decode over an e4m3 cache (prefill_full into it, then
    decode_with_cache or its speculative twin, k 3): every step embeds in
    bf16, as JAX's, and the tokens are JAX's over its e4m3 session cache."""
    cfg, jllm, tllm, embeds, ids = model
    seq_lens, mask, pos = _prompt()
    max_new, k, t_max = 8, 3, 24
    prompt_ids = np.where(mask, ids, -1).astype(np.int32)

    jcache = jax_llama.init_cache(cfg.llm, len(SEQ_LENS), t_max, dtype=jnp.float8_e4m3fn)
    jlogits, jcache = jax_gen.prefill_full(jllm, cfg.llm, jcache, jnp.asarray(embeds),
                                           jnp.asarray(seq_lens), jnp.asarray(mask),
                                           jnp.asarray(pos))
    if spec:
        want = jax_gen.decode_with_cache_spec(
            jllm, cfg.llm, jcache, jlogits, jnp.asarray(seq_lens), jnp.asarray(prompt_ids),
            jnp.asarray(seq_lens), _jax_stop(), jax.random.PRNGKey(0), max_new_tokens=max_new,
            spec_k=k)[:2]
    else:
        want = jax_gen.decode_with_cache(jllm, cfg.llm, jcache, jlogits, jnp.asarray(seq_lens),
                                         _jax_stop(), jax.random.PRNGKey(0),
                                         max_new_tokens=max_new)[:2]

    cache = torch_llama.init_cache(cfg.llm, len(SEQ_LENS), t_max, dtype=E4M3, device="cpu")
    logits0, _ = torch_gen.prefill_full(tllm, cfg.llm, cache, torch.from_numpy(embeds),
                                        torch.from_numpy(seq_lens), torch.from_numpy(mask),
                                        torch.from_numpy(pos))
    seen = []
    embed = torch_llama.embed_tokens

    def recorded(params, input_ids, dtype=None):
        seen.append(dtype)
        return embed(params, input_ids, dtype=dtype)

    monkeypatch.setattr(torch_llama, "embed_tokens", recorded)
    if spec:
        got = torch_gen.decode_with_cache_spec(
            tllm, cfg.llm, cache, logits0, torch.from_numpy(seq_lens), prompt_ids, seq_lens,
            _torch_stop(), torch.Generator(), max_new_tokens=max_new, spec_k=k)[:2]
    else:
        got = torch_gen.decode_with_cache(tllm, cfg.llm, cache, logits0,
                                          torch.from_numpy(seq_lens), _torch_stop(),
                                          torch.Generator(), max_new_tokens=max_new)[:2]
    assert seen and set(seen) == {torch.bfloat16}
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))  # n_gen
    _assert_tokens_up_to_bf16_ties(model, got[0].numpy(), np.asarray(want[0]), logits0)


# Two bf16 paths (this port's and JAX's) differ by ~2^-8 of an activation, so
# two logits within BF16_TIE of the larger may come out in either order.
BF16_TIE = 1e-2


def _assert_tokens_up_to_bf16_ties(model, got, want, logits0):
    """Each row's tokens equal JAX's, or first leave them where the port's
    own logits for that position, teacher-forced over a fresh e4m3 session
    cache in one verify block, hold both tokens as their top two within
    BF16_TIE of each other."""
    cfg, _, tllm, embeds, _ = model
    seq_lens, mask, pos = _prompt()
    for row in range(len(SEQ_LENS)):
        diff = np.flatnonzero(got[row] != want[row])
        if not diff.size:
            continue
        first = int(diff[0])
        if first == 0:
            top = torch.topk(logits0[row], 2)
        else:
            cache = torch_llama.init_cache(cfg.llm, len(SEQ_LENS), 24, dtype=E4M3, device="cpu")
            torch_gen.prefill_full(tllm, cfg.llm, cache, torch.from_numpy(embeds),
                                   torch.from_numpy(seq_lens), torch.from_numpy(mask),
                                   torch.from_numpy(pos))
            blk = torch.from_numpy(np.repeat(got[row:row + 1, :first], len(SEQ_LENS), 0)).long()
            slots = torch.from_numpy(seq_lens)[:, None].long() + torch.arange(first)[None, :]
            logits = torch_llama.llama_forward(
                tllm, cfg.llm, torch_llama.embed_tokens(tllm, blk, dtype=torch.bfloat16),
                position_ids=slots, cache=cache, write_slots=slots, logits_mode="all",
                spec_verify=True)
            top = torch.topk(logits[row, first - 1], 2)
        assert {int(got[row, first]), int(want[row, first])} == set(top.indices.tolist()), row
        assert (top.values[0] - top.values[1]) <= BF16_TIE * top.values[0].abs(), row


def test_graph_entries_keep_e4m3_and_bf16_apart(model):
    """An e4m3 call and a bf16 one with every other part of the key equal
    take two entries, each with a cache of its own dtype; the same e4m3 call
    again takes its entry (bookkeeping only: no capture on the CPU)."""
    cfg, _, tllm, _, _ = model
    step_kw = dict(temperature=0.0, do_sample=False, top_p=1.0, pad_id=0,
                   emb_dtype=torch.bfloat16)
    torch_gen.clear_decode_graphs()
    try:
        def entry(kv_dtype, kw=step_kw, **more):
            return torch_gen._decode_graph(tllm, cfg.llm, 3, 20, 10, (1, 2),
                                           torch.device("cpu"), kw, kv_dtype=kv_dtype, **more)

        plain, fp8 = entry(None), entry(E4M3)
        assert plain is not fp8 and entry(E4M3) is fp8 and entry(torch.bfloat16) is plain
        assert plain.state.cache.dtype == torch.bfloat16 and fp8.state.cache.dtype == E4M3
        assert not fp8.state.cache.k.float().any()
        spec_kw = torch_gen._spec_kw(3, 0.0, False, 1.0, 0, torch.bfloat16)
        spec = entry(E4M3, spec_kw, hist_width=12)
        assert spec is not fp8 and spec.state.cache.dtype == E4M3
        assert entry(None, spec_kw, hist_width=12).state.cache.dtype == torch.bfloat16
        caller = torch_llama.init_cache(cfg.llm, 3, 20, dtype=E4M3, device="cpu")
        assert entry(None, cache=caller).state.cache is caller
        assert len(torch_gen.decode_graphs()) == torch_gen.MAX_DECODE_GRAPHS
    finally:
        torch_gen.clear_decode_graphs()


def test_kv_dtype_is_the_models_or_e4m3():
    """`kv_dtype`: None or the model's dtype, or float8_e4m3fn by name or as
    a torch dtype; any other raises. An e4m3 cache is made zeroed."""
    assert torch_llama.kv_dtype_of(None, torch.float32) == torch.float32
    assert torch_llama.kv_dtype_of("float32", torch.float32) == torch.float32
    assert torch_llama.kv_dtype_of("float8_e4m3fn", torch.bfloat16) == E4M3
    assert torch_llama.kv_dtype_of(E4M3, torch.bfloat16) == E4M3
    for other in ("float8_e5m2", "bfloat16", torch.float16, "int8", "no_such_dtype"):
        with pytest.raises(ValueError, match="kv_dtype"):
            torch_llama.kv_dtype_of(other, torch.float32)
    cache = torch_llama.init_cache(tiny_test_config().llm, 2, 9, dtype=E4M3, device="cpu")
    assert cache.dtype == cache.v.dtype == E4M3 and not cache.k.view(torch.uint8).any()


# ---------------------------------------------------------------- the engine


@pytest.fixture(scope="module")
def models(model):
    """(the port's TEOChat, JAX's) on the tiny model's weights."""
    cfg = dataclasses.replace(tiny_test_config(vocab_size=128), dtype="float32")
    params = jax_teochat.init_teochat(jax.random.PRNGKey(7), cfg)
    llm = dict(params["llm"])
    llm["lm_head"] = {"kernel": llm["lm_head"]["kernel"] * 40.0}
    params = jax.tree.map(np.asarray, {**params, "llm": llm})
    return (torch_teochat.TEOChat(cfg, to_torch(params, "cpu"), tokenizer=MockTokenizer()),
            jax_teochat.TEOChat(cfg, params, tokenizer=MockTokenizer()))


def _served(engine, prompts, gen):
    engine.start()
    try:
        return [list(map(int, engine.submit(ids, fr, gen))) for ids, fr in prompts]
    finally:
        engine.shutdown()


@pytest.mark.parametrize("kw", [dict(max_slots=4, max_len=96, chunk=2, prefill_chunk=16),
                                dict(max_slots=4, max_len=96, chunk=2, speculative_k=3)],
                         ids=["plain_chunked_prefill", "speculative"])
def test_engine_e4m3_matches_jaxs(models, kw):
    """`BatchEngine(kv_dtype="float8_e4m3fn")` against the JAX engine with
    the same kv_dtype and arguments: each 2-frame request's greedy tokens
    (a long one prefilled in pieces of 16 in the plain engine), and its pool
    is e4m3."""
    prompts = _prompts(3)
    prompts[2] = (prompts[2][0] + list(range(20, 40)), prompts[2][1])  # longer than a piece
    ours = BatchEngine(models[0], kv_dtype="float8_e4m3fn", **kw)
    assert ours.cache.k.dtype == E4M3
    got = _served(ours, prompts, GenerationConfig(max_new_tokens=8, temperature=0.0,
                                                  do_sample=False, stop_strings=()))
    theirs = jax_engine.BatchEngine(models[1], kv_dtype="float8_e4m3fn", **kw)
    assert theirs.cache.k.dtype == jnp.float8_e4m3fn
    want = _served(theirs, prompts, JaxGenerationConfig(max_new_tokens=8, temperature=0.0,
                                                        do_sample=False, stop_strings=()))
    assert got == want and all(len(r) == 8 for r in got)
    if "speculative_k" in kw:
        assert ours.stats["spec_iterations"] > 0


# ----------------------------------------------------------------- the bench


@pytest.mark.parametrize("kv_dtype,itemsize", [(None, 4), ("float8_e4m3fn", 1)])
def test_bench_counts_the_cache_at_its_itemsize(kv_dtype, itemsize):
    """decode_bs32's and decode_int4's e4m3 runs read one byte a cached
    value: `kv_bytes` is sized at the cache's itemsize (the tiny model's
    own dtype, fp32, otherwise), and the run decodes."""
    cfg = dataclasses.replace(tiny_test_config(), dtype="float32")
    st = bench_main.Settings(cfg=cfg, device="cpu", prompt_len=32, text_tokens=20, decode_new=4)
    run_generate, max_new, _ = bench_main.build_decode_setup(st, batch=2, quant="int4",
                                                             kv_dtype=kv_dtype)
    llm = cfg.llm
    live = 2 * 31 + 2 * 1.5
    assert run_generate.kv_bytes == (2 * llm.num_layers * live * llm.num_kv_heads
                                     * llm.head_dim * itemsize)
    toks = run_generate(max_new)
    assert toks.shape == (2, 4) and ((toks >= 0) & (toks < llm.vocab_size)).all()
    assert "decode_bs32" in bench_main.PHASES
