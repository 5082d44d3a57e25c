"""The port's prompt-lookup speculative decoding against the JAX package, on the CPU.

`teochat_torch.models.generation` runs the speculative loop as one verify
iteration of fixed-shape device tensors (`SpecState`, `_spec_iteration`),
`done` read once every SPEC_CHUNK iterations; on the card the iteration
replays from a CUDA graph, here it runs eagerly in the same chunks. Held
against the JAX functions on the tiny fp32 model of
test_torch_decode_graph.py (lm_head x40, so reduction-order noise cannot
flip an argmax; int8 and int4 trees quantized by the JAX package after the
scaling and carried across by the bridge):

- the drafting helpers `_ngram_match_start` / `_draft_lookup` on random,
  short and negative-id histories: exactly;
- `generate_tokens_spec`, greedy, k 1 / 3 / 5, a ragged batch of 3, EOS
  inside the run, a max_new_tokens cut, float / int8 / int4 weights: the
  tokens, n_gen, steps and accepted exactly (and at SPEC_CHUNK 1, 2, 4);
- the oracle (the bench's workload forcing): the tokens are the oracle's,
  steps and accepted JAX's;
- `decode_with_cache_spec` over a prefilled cache: tokens and counters
  exactly, the committed slots within RTOL, ATOL = 1e-4, 1e-5;
- `TEOChat.generate(speculative_k=3)` on a batch with frames:
  `last_spec_stats` and the tokens;
- the verify block's mask: the loop passes no kv_mask, and `lengths =
  q_slot + 1` is what JAX's `slot <= q_slot & slot <= pos0 + k` gives, in
  lengths, in attention and through `llama_forward(spec_verify=True)`.

Against the port alone: `_sample_excluding`'s residual mass by counts (3,000
draws, within 0.05, as tests/test_speculative.py); draft corruption keeps the
plain greedy tokens (the RNGs differ from JAX's, so the steps may too), and
a keep rate p gives Σ p^j tokens an iteration under an oracle (600 tokens);
sampled speculation's token distribution within the self-calibrated noise
floor of plain sampling (TV, margin 0.12, as tests/test_speculative.py); an
iteration reads nothing back to the host (fp32, int8, int4; greedy with the
bench's knobs, and sampled); iterations after every row is done change no
output or counter; the spec graph entries' keys, bound and lifetime.

The JAX side is held to about twenty compilations (the XLA CPU compiler
survives a few hundred a process).
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
from teochat_tpu.ops import quant as jax_quant
from teochat_tpu.ops.attention import xla_attention
from teochat_torch.checkpoint.bridge import to_torch
from teochat_torch.models import generation as torch_gen
from teochat_torch.models import llama as torch_llama
from teochat_torch.models import teochat as torch_teochat
from teochat_torch.ops import decode_attention as dec_mod
from teochat_torch.ops import quant as torch_quant

RTOL, ATOL = 1e-4, 1e-5
S = 8
SEQ_LENS = [7, 4, 6]  # a ragged batch of 3, right-padded to S
# row 0 repeats itself (prompt-lookup drafts hit), rows 1 and 2 are random
IDS = np.array([[5, 6, 7, 5, 6, 7, 5, 0], [20, 31, 44, 57, 0, 0, 0, 0],
                [90, 17, 63, 90, 17, 12, 0, 0]], np.int32)
NEVER = 127  # an EOS id the tiny model never picks in these runs


@pytest.fixture(scope="module")
def model():
    """The JAX TEOChat config and params (numpy), the torch params, and the
    prompt's embeddings."""
    cfg = dataclasses.replace(tiny_test_config(vocab_size=128), dtype="float32")
    params = jax_teochat.init_teochat(jax.random.PRNGKey(7), cfg)
    llm = dict(params["llm"])
    llm["lm_head"] = {"kernel": llm["lm_head"]["kernel"] * 40.0}  # well-separated argmax
    params = jax.tree.map(np.asarray, {**params, "llm": llm})
    embeds = params["llm"]["embed_tokens"]["embedding"][IDS].astype(np.float32)
    return cfg, params, to_torch(params, "cpu"), embeds


@pytest.fixture(scope="module")
def llms(model):
    """{quant: (JAX llm params as numpy, the torch llm params)} for the
    float tree and the int8 and int4 trees the JAX package quantizes."""
    _, params, tparams, _ = model
    out = {None: (params["llm"], tparams["llm"])}
    for quant, fn in (("int8", jax_quant.quantize_llama_params),
                      ("int4", jax_quant.quantize_llama_params_int4)):
        q = jax.tree.map(np.asarray, fn(params["llm"]))
        out[quant] = (q, to_torch(q, "cpu"))
    return out


def _prompt():
    seq_lens = np.array(SEQ_LENS, np.int32)
    mask = np.arange(S)[None, :] < seq_lens[:, None]
    pos = np.where(mask, np.arange(S)[None, :], 0).astype(np.int32)
    prompt_ids = np.where(mask, IDS, -1).astype(np.int32)
    return seq_lens, mask, pos, prompt_ids


def _jax_stop(eos):
    return jax_gen.StopSpec(keyword_ids=jnp.zeros((1, 1), jnp.int32),
                            keyword_lens=jnp.zeros((1,), jnp.int32),
                            eos_id=jnp.asarray(eos, jnp.int32))


def _torch_stop(eos):
    return torch_gen.StopSpec(keyword_ids=np.zeros((1, 1), np.int32),
                              keyword_lens=np.zeros((1,), np.int32), eos_id=int(eos))


def _jax_spec(model, jllm, k, max_new, eos=NEVER, oracle=None):
    cfg, _, _, embeds = model
    seq_lens, mask, pos, prompt_ids = _prompt()
    out = jax_gen.generate_tokens_spec(
        jllm, cfg.llm, jnp.asarray(embeds), jnp.asarray(seq_lens), jnp.asarray(mask),
        jnp.asarray(pos), jnp.asarray(prompt_ids), jnp.asarray(seq_lens), _jax_stop(eos),
        max_new_tokens=max_new, cache_len=S + max_new + k + 1, spec_k=k,
        oracle_ids=None if oracle is None else jnp.asarray(oracle))
    return tuple(np.asarray(x) for x in out)


def _torch_spec(model, tllm, k, max_new, eos=NEVER, oracle=None, generator=None, **kw):
    cfg, _, _, embeds = model
    seq_lens, mask, pos, prompt_ids = _prompt()
    out = torch_gen.generate_tokens_spec(
        tllm, cfg.llm, torch.from_numpy(embeds), torch.from_numpy(seq_lens),
        torch.from_numpy(mask), torch.from_numpy(pos), prompt_ids, seq_lens, _torch_stop(eos),
        generator or torch.Generator().manual_seed(0), max_new_tokens=max_new,
        cache_len=S + max_new + k + 1, spec_k=k, oracle_ids=oracle, **kw)
    return tuple(t.numpy() for t in out)


def _assert_same(got, want, what):
    for name, g, w in zip(("tokens", "n_gen", "steps", "accepted"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {name}")


# ------------------------------------------------------------ the drafts


def _histories():
    """[B, 24] histories and their lengths: random ids over a small
    alphabet (many n-gram repeats), a short history, negative ids (pads
    and image sentinels) inside and past the valid part, and a row with
    no repeat at all."""
    rs = np.random.RandomState(3)
    h = 24
    hist = rs.randint(0, 4, size=(8, h)).astype(np.int32)
    lens = rs.randint(4, h + 1, size=8).astype(np.int32)
    hist[2, :] = -1
    hist[2, :3] = [7, 8, 7]  # short: 3 tokens
    lens[2] = 3
    hist[3, 5] = hist[3, 9] = IMG  # sentinels inside
    hist[3, lens[3]:] = -1
    hist[4] = np.arange(h)  # no n-gram repeats
    hist[5, :10] = [3, 1, 2, 3, 1, -1, 3, 1, 2, 3]  # a trigram across a pad does not match
    lens[5] = 10
    hist[6, :] = 2  # one token over and over
    lens[6] = h
    return hist, lens


@pytest.mark.parametrize("n", [2, 3])
def test_ngram_match_start_matches_jax(n):
    hist, lens = _histories()
    want = np.asarray(jax.jit(jax_gen._ngram_match_start, static_argnums=2)(
        jnp.asarray(hist), jnp.asarray(lens), n))
    got = torch_gen._ngram_match_start(torch.from_numpy(hist), torch.from_numpy(lens), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).any() and (want < 0).any()  # both kinds of row occur


@pytest.mark.parametrize("k", [1, 4])
def test_draft_lookup_matches_jax(k):
    hist, lens = _histories()
    want = np.asarray(jax.jit(jax_gen._draft_lookup, static_argnums=2)(
        jnp.asarray(hist), jnp.asarray(lens), k))
    got = torch_gen._draft_lookup(torch.from_numpy(hist), torch.from_numpy(lens), k)
    assert got.dtype == torch.int32 and got.shape == (8, k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got >= 0).all()


def test_draft_lookup_cases_of_the_jax_tests():
    """tests/test_speculative.py's cases, exactly: the most recent bigram, no
    match drafting zeros, the trigram beating a later bigram, a history of
    three slots, one of fewer slots than the trigram."""
    hist = torch.tensor([[1, 5, 6, 7, 8, 2, 5, 6, 9, 5, 6, -1, -1],
                         [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, -1, -1]], dtype=torch.int32)
    lens = torch.tensor([11, 11], dtype=torch.int32)
    assert torch_gen._draft_lookup(hist, lens, 3).tolist() == [[9, 5, 6], [0, 0, 0]]
    hist = torch.tensor([[9, 5, 6, 7, 2, 5, 6, 1, 9, 5, 6]], dtype=torch.int32)
    assert torch_gen._draft_lookup(hist, torch.tensor([11]), 2).tolist() == [[7, 2]]
    d = torch_gen._draft_lookup(torch.tensor([[4, -1, -1]], dtype=torch.int32),
                                torch.tensor([1]), 2)
    assert d.shape == (1, 2) and (d >= 0).all()
    d = torch_gen._draft_lookup(torch.tensor([[4, 4]], dtype=torch.int32), torch.tensor([2]), 3)
    assert d.tolist() == [[0, 0, 0]]


def test_sample_excluding_residual_math():
    """The excluded token is never drawn; with it the residual [0, .6, .4],
    without one the distribution itself (3,000 draws, within 0.05)."""
    n = 3000
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.2]])).expand(n, 3)
    gen = torch.Generator().manual_seed(0)
    draw = torch_gen._sample_excluding(logits, gen, 1.0, 1.0, torch.zeros(n, dtype=torch.int32))
    counts = np.bincount(draw.numpy(), minlength=3) / n
    assert draw.dtype == torch.int32 and counts[0] == 0
    assert abs(counts[1] - 0.6) < 0.05 and abs(counts[2] - 0.4) < 0.05
    draw = torch_gen._sample_excluding(logits, gen, 1.0, 1.0, torch.full((n,), -1))
    counts = np.bincount(draw.numpy(), minlength=3) / n
    assert abs(counts[0] - 0.5) < 0.05 and abs(counts[1] - 0.3) < 0.05
    # top-p 0.7 keeps tokens 0 and 1; with 0 excluded, only 1 is left
    draw = torch_gen._sample_excluding(logits, gen, 1.0, 0.7, torch.zeros(n, dtype=torch.int32))
    assert (draw == 1).all()


# ---------------------------------------------------- the loop against JAX


@pytest.fixture(scope="module")
def free_runs(model, llms):
    """JAX's greedy speculative runs of 11 tokens (no stop) for k 1, 3, 5."""
    return {k: _jax_spec(model, llms[None][0], k, 11) for k in (1, 3, 5)}


@pytest.mark.parametrize("k", [1, 3, 5])
def test_greedy_spec_matches_jax(model, llms, free_runs, k):
    want = free_runs[k]
    got = _torch_spec(model, llms[None][1], k, 11)
    _assert_same(got, want, f"k {k}")
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32
    assert (want[1] == 11).all() and int(want[3]) > 0  # drafts were accepted


def test_greedy_spec_equals_plain_greedy(model, llms, free_runs):
    """Speculation changes the iterations, not the tokens."""
    cfg, _, _, embeds = model
    seq_lens, mask, pos, _ = _prompt()
    plain, _ = torch_gen.generate_tokens(
        llms[None][1], cfg.llm, torch.from_numpy(embeds), torch.from_numpy(seq_lens),
        torch.from_numpy(mask), torch.from_numpy(pos), _torch_stop(NEVER),
        torch.Generator(), max_new_tokens=11, cache_len=S + 12)
    for k in (1, 3, 5):
        np.testing.assert_array_equal(free_runs[k][0], plain.numpy(), err_msg=f"k {k}")


def test_eos_inside_the_run_and_the_chunks_match_jax(model, llms, free_runs, monkeypatch):
    """EOS: row 1 stops at its third token, the others run on; the port's
    loop at SPEC_CHUNK 1, 2 and 4 gives JAX's tokens, n_gen, steps and
    accepted (the iterations a chunk runs past the last stop count nothing)."""
    eos = int(free_runs[3][0][1, 2])
    want = _jax_spec(model, llms[None][0], 3, 11, eos=eos)
    assert want[1].tolist()[1] == 3 and want[1].max() > 3
    for chunk in (1, 2, 4):
        monkeypatch.setattr(torch_gen, "SPEC_CHUNK", chunk)
        _assert_same(_torch_spec(model, llms[None][1], 3, 11, eos=eos), want, f"chunk {chunk}")


def test_max_new_tokens_cut_matches_jax(model, llms, free_runs):
    """max_new_tokens 5 cuts every row inside a verify block (k 3)."""
    want = _jax_spec(model, llms[None][0], 3, 5)
    _assert_same(_torch_spec(model, llms[None][1], 3, 5), want, "max_new 5")
    np.testing.assert_array_equal(want[0], free_runs[3][0][:, :5])


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_spec_matches_jax(model, llms, quant):
    jllm, tllm = llms[quant]
    want = _jax_spec(model, jllm, 3, 11)
    _assert_same(_torch_spec(model, tllm, 3, 11), want, quant)
    assert int(want[3]) > 0


def test_oracle_targets_are_emitted_exactly(model, llms):
    """The bench's oracle: the target sequence is the oracle's where it has
    a token (>= 0). Row 0 echoes its prompt (drafts accepted), row 1 is
    random, row 2 falls back to the model's argmax after four tokens."""
    rs = np.random.RandomState(5)
    oracle = np.stack([np.tile([5, 6, 7], 4)[:11], rs.randint(3, 120, 11),
                       np.r_[[90, 17, 12, 90], [-1] * 7]]).astype(np.int32)
    want = _jax_spec(model, llms[None][0], 4, 11, oracle=oracle)
    got = _torch_spec(model, llms[None][1], 4, 11, oracle=oracle)
    _assert_same(got, want, "oracle")
    np.testing.assert_array_equal(got[0][:2], oracle[:2])
    np.testing.assert_array_equal(got[0][2, :4], oracle[2, :4])
    assert int(want[3]) > 0


def test_draft_corruption_keeps_the_greedy_tokens(model, llms, free_runs):
    """The bench's keep probability corrupts drafts before verification:
    the tokens stay the plain greedy ones at every rate; keeping none
    accepts none, keeping all accepts what verbatim drafting accepts. The
    port draws from its generator (JAX folds its key), so the steps at the
    middle rate are its own."""
    tllm = llms[None][1]
    accepted = {}
    for keep in (1.0, 0.5, 0.0):
        got = _torch_spec(model, tllm, 3, 11, draft_keep_prob=keep,
                          generator=torch.Generator().manual_seed(4))
        np.testing.assert_array_equal(got[0], free_runs[3][0], err_msg=f"keep {keep}")
        accepted[keep] = int(got[3])
    assert accepted[0.0] == 0 and accepted[1.0] == int(free_runs[3][3])
    assert accepted[0.5] <= accepted[1.0]
    # the keep probability is the state's device scalar: a tensor works alike
    got = _torch_spec(model, tllm, 3, 11, draft_keep_prob=torch.tensor(0.0))
    assert int(got[3]) == 0


def test_draft_corruption_rate_sets_the_acceptance(model):
    """With an oracle that continues the history's cycle of 5 ids, every
    verbatim draft is accepted, so a keep rate p gives Σ p^j tokens an
    iteration over j <= min(k, 5) (a draft cannot run past the history's
    end). 600 tokens at k 4 (about 300 iterations at p 0.5, the mean's sd
    ~0.07): within 0.25 of it."""
    cfg, _, tparams, _ = model
    cycle, s, n = [60, 61, 62, 63, 64], 20, 600
    ids = np.asarray([(cycle * 4)[:s]], np.int32)
    oracle = np.asarray([[cycle[(s + i) % 5] for i in range(n)]], np.int32)
    emb = torch.from_numpy(np.random.RandomState(6).randn(1, s, cfg.llm.hidden_size)
                           .astype(np.float32) * 0.02)
    for p in (0.75, 0.5):
        tokens, _, steps, _ = torch_gen.generate_tokens_spec(
            tparams["llm"], cfg.llm, emb, torch.tensor([s]), torch.ones(1, s, dtype=torch.bool),
            torch.arange(s)[None], ids, np.asarray([s]), _torch_stop(NEVER),
            torch.Generator().manual_seed(1), max_new_tokens=n, cache_len=s + n + 5,
            spec_k=4, oracle_ids=oracle, draft_keep_prob=p)
        np.testing.assert_array_equal(tokens.numpy(), oracle)
        assert abs(n / int(steps) - sum(p ** j for j in range(5))) < 0.25, (p, n / int(steps))


def test_sampled_spec_distribution_matches_plain_sampling(model):
    """Exact speculative sampling: the sampled tokens at positions 0 and 1
    are distributed as plain sampling's (the unscaled model, temperature
    0.8, 512 rows), held to the noise floor of two plain runs + 0.12 in
    total variation, as the JAX package's test. Seeded: not flaky."""
    cfg, params, _, _ = model
    llm = dict(params["llm"])
    llm["lm_head"] = {"kernel": llm["lm_head"]["kernel"] / 40.0}
    tm = torch_teochat.TEOChat(cfg, to_torch({**params, "llm": llm}, "cpu"))
    ids = [[1, 5, 9, 4, 5, 9]] * 512
    plain = GenerationConfig(max_new_tokens=2, do_sample=True, temperature=0.8,
                             stop_strings=())
    spec = dataclasses.replace(plain, speculative_k=3)
    pa, pb = tm.generate(ids, None, plain, rng=1), tm.generate(ids, None, plain, rng=2)
    sp = tm.generate(ids, None, spec, rng=3)
    assert tm.last_spec_stats["tokens"] == sum(len(r) for r in sp)

    def tv(a, b):
        return 0.5 * sum(abs(a.count(t) / len(a) - b.count(t) / len(b)) for t in set(a) | set(b))

    for pos in (0, 1):
        a, b, s = ([r[pos] for r in rows if len(r) > pos] for rows in (pa, pb, sp))
        assert tv(a, s) < tv(a, b) + 0.12, (pos, tv(a, b), tv(a, s))


def test_decode_with_cache_spec_matches_jax(model, llms):
    """Over a prefilled cache (the session's path): JAX's prefill carried
    across as numpy, then the speculative decode on both; the tokens and
    counters exactly, the committed slots (every token's K/V but the last
    one's) within RTOL, ATOL."""
    cfg, _, _, embeds = model
    jllm, tllm = llms[None]
    seq_lens, mask, pos, prompt_ids = _prompt()
    max_len, k, max_new = 40, 3, 9
    jlogits, jcache = jax_gen.prefill_full(
        jllm, cfg.llm, jax_llama.init_cache(cfg.llm, 3, max_len, dtype=jnp.float32),
        jnp.asarray(embeds), jnp.asarray(seq_lens), jnp.asarray(mask), jnp.asarray(pos))
    tcache = torch_llama.KVCache(k=torch.from_numpy(np.array(jcache.k)),
                                 v=torch.from_numpy(np.array(jcache.v)))
    tlogits = torch.from_numpy(np.array(jlogits))
    want = jax_gen.decode_with_cache_spec(
        jllm, cfg.llm, jcache, jlogits, jnp.asarray(seq_lens), jnp.asarray(prompt_ids),
        jnp.asarray(seq_lens), _jax_stop(NEVER), jax.random.PRNGKey(0),
        max_new_tokens=max_new, spec_k=k)
    got = torch_gen.decode_with_cache_spec(
        tllm, cfg.llm, tcache, tlogits, torch.from_numpy(seq_lens), prompt_ids, seq_lens,
        _torch_stop(NEVER), torch.Generator(), max_new_tokens=max_new, spec_k=k)
    assert got[4] is tcache
    _assert_same([t.numpy() for t in got[:4]], [np.asarray(x) for x in want[:4]], "session")
    jk, jv = np.asarray(want[4].k), np.asarray(want[4].v)
    for row, n in enumerate(np.asarray(want[1])):
        kept = slice(0, int(seq_lens[row] + n - 1))
        np.testing.assert_allclose(tcache.k[:, row, kept].numpy(), jk[:, row, kept],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tcache.v[:, row, kept].numpy(), jv[:, row, kept],
                                   rtol=RTOL, atol=ATOL)


def test_teochat_generate_spec_stats_match_jax(model):
    """TEOChat.generate(speculative_k=3) on a batch with frames: the tokens
    and `last_spec_stats` are the JAX model's, and the tokens are the plain
    path's."""
    cfg, params, tparams, _ = model
    jm, tm = jax_teochat.TEOChat(cfg, params), torch_teochat.TEOChat(cfg, tparams)
    rows = [[1, 5, IMG, 9, 4, 5, 9, 4], [1, 7, 8, IMG, IMG, 3, 7, 8, 3]]
    frames = np.random.RandomState(1).randn(3, 3, 28, 28).astype(np.float32)
    gen = GenerationConfig(max_new_tokens=9, do_sample=False, temperature=0.0,
                           stop_strings=(), speculative_k=3)
    want = jm.generate(rows, frames, gen)
    assert tm.generate(rows, frames, gen) == want
    assert tm.last_spec_stats == jm.last_spec_stats
    assert tm.last_spec_stats["tokens"] == sum(len(r) for r in want)
    assert tm.generate(rows, frames, dataclasses.replace(gen, speculative_k=0)) == want


# ----------------------------------------------------- the verify block's mask


def _loop_shapes():
    """pos0 of a batch of the loop (mid-cache, at the clip, past it as a done
    row's may be) and its block's slots min(pos0 + j, t_max - 2)."""
    t_max, k = 30, 4
    pos0 = np.array([3, t_max - k - 2, t_max - k - 1, t_max - 3], np.int64)
    blk_pos = np.minimum(pos0[:, None] + np.arange(k + 1)[None, :], t_max - 2)
    return t_max, k, pos0, blk_pos


def test_verify_lengths_are_jax_masks():
    """For every query of the block, `query_lengths(blk_pos)` (no kv_mask,
    no host read) is the length of JAX's mask `slot <= q_slot & slot <=
    pos0 + k`, which is a prefix of the row."""
    t_max, k, pos0, blk_pos = _loop_shapes()
    slot = np.arange(t_max)
    mask = (slot[None, None, :] <= blk_pos[:, :, None]) & \
        (slot[None, None, :] <= (pos0 + k)[:, None, None])
    lengths = mask.sum(-1)
    np.testing.assert_array_equal(mask, slot[None, None, :] < lengths[..., None])  # prefixes
    got = dec_mod.query_lengths(torch.from_numpy(blk_pos))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), lengths)


def test_verify_block_forward_matches_jax_with_its_mask(model):
    """One verify block through `llama_forward(spec_verify=True)` without a
    kv_mask against JAX's with the loop's kv_mask `slot <= pos0 + k`, over a
    cache of random committed K/V: the logits of every query, and the
    attention alone through K2m's plain version against `xla_attention`
    under the same mask."""
    cfg, params, tparams, _ = model
    t_max, k, pos0, blk_pos = _loop_shapes()
    b, llm = len(pos0), cfg.llm
    rs = np.random.RandomState(2)
    shape = (llm.num_layers, b, t_max, llm.num_kv_heads, llm.head_dim)
    k0, v0 = rs.randn(*shape).astype(np.float32), rs.randn(*shape).astype(np.float32)
    emb = rs.randn(b, k + 1, llm.hidden_size).astype(np.float32)
    kv_mask = np.arange(t_max)[None, :] <= (pos0 + k)[:, None]
    want, _ = jax_llama.llama_forward(
        params["llm"], llm, jnp.asarray(emb), position_ids=jnp.asarray(blk_pos, jnp.int32),
        cache=jax_llama.KVCache(k=jnp.asarray(k0), v=jnp.asarray(v0)),
        write_slots=jnp.asarray(blk_pos, jnp.int32), kv_mask=jnp.asarray(kv_mask),
        logits_mode="all", spec_verify=True)
    got = torch_llama.llama_forward(
        tparams["llm"], llm, torch.from_numpy(emb), position_ids=torch.from_numpy(blk_pos),
        cache=torch_llama.KVCache(k=torch.from_numpy(k0.copy()), v=torch.from_numpy(v0.copy())),
        write_slots=torch.from_numpy(blk_pos), logits_mode="all", spec_verify=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)

    q = rs.randn(b, k + 1, llm.num_heads, llm.head_dim).astype(np.float32)
    slot = np.arange(t_max)
    mask = (slot[None, None, :] <= blk_pos[:, :, None]) & kv_mask[:, None, :]
    want = xla_attention(jnp.asarray(q), jnp.asarray(k0[0]), jnp.asarray(v0[0]),
                         mask=jnp.asarray(mask))
    kt, vt = (torch.from_numpy(a[0]).transpose(1, 2) for a in (k0, v0))
    got = dec_mod.decode_attention_multi(torch.from_numpy(q), kt, vt,
                                         dec_mod.query_lengths(torch.from_numpy(blk_pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


# ------------------------------------------------ the iteration on the host


def _state(tllm, cfg, *, draft_keep=False, oracle=False, k=3, max_new=6):
    cache = torch_llama.init_cache(cfg, 3, S + max_new + k + 1, dtype=torch.float32,
                                   device="cpu")
    seq_lens, _, _, prompt_ids = _prompt()
    st = torch_gen.SpecState.new(cache, cfg.vocab_size, max_new, (1, 2), S + max_new,
                                 draft_keep=draft_keep, oracle=oracle)
    logits = torch.randn(3, cfg.vocab_size, generator=torch.Generator().manual_seed(1))
    st.reset(torch.from_numpy(seq_lens), logits, prompt_ids, seq_lens,
             torch_gen.StopSpec(np.array([[5, 6]], np.int32), np.array([2], np.int32), 9), 0,
             keep_prob=0.5 if draft_keep else None,
             oracle_ids=np.full((3, max_new), -1, np.int32) if oracle else None)
    return st


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_an_iteration_reads_nothing_back(model, monkeypatch, quant):
    """Three verify iterations with every method that copies a tensor's
    values to the host patched to raise: greedy with the bench's keep
    probability and oracle, and sampled (the residual draw, acceptance by
    u < P(d)). The loop can run as a CUDA graph."""
    cfg, _, tparams, _ = model
    tllm = tparams["llm"]
    if quant == "int8":
        tllm = torch_quant.quantize_llama_params(tllm)
    elif quant == "int4":
        tllm = torch_quant.quantize_llama_params_int4(tllm)
    kw = dict(spec_k=3, top_p=0.9, pad_id=0, emb_dtype=torch.float32)
    runs = [(_state(tllm, cfg.llm, draft_keep=True, oracle=True),
             dict(kw, temperature=0.0, do_sample=False, draft_keep=True, oracle=True)),
            (_state(tllm, cfg.llm), dict(kw, temperature=0.8, do_sample=True))]

    def refuse(*_a, **_k):
        raise AssertionError("a verify iteration read a tensor back to the host")

    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__",
                 "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    gen = torch.Generator().manual_seed(0)
    for st, step_kw in runs:
        for _ in range(3):
            torch_gen._spec_iteration(tllm, cfg.llm, st, gen, **step_kw)
    monkeypatch.undo()
    for st, _ in runs:  # each iteration records a token in each row not done
        assert 1 <= int(st.steps) <= 3 and (st.n_gen >= 1).all() and (st.n_gen <= 6).all()
        assert 0 <= int(st.accepted) <= int(st.n_gen.sum()) - 3
        for row, n in enumerate(st.n_gen.tolist()):
            assert (st.tokens[row, n:] == 0).all()  # pad_id after the recorded tokens


def test_iterations_after_every_row_is_done_change_nothing(model):
    """Run the loop eagerly to its end, then more iterations: the tokens,
    n_gen, history, steps and accepted stay as they were."""
    cfg, _, tparams, _ = model
    tllm = tparams["llm"]
    st = _state(tllm, cfg.llm)
    kw = dict(spec_k=3, temperature=0.0, do_sample=False, top_p=1.0, pad_id=0,
              emb_dtype=torch.float32)
    gen = torch.Generator()
    torch_gen._run_spec_decode_loop(tllm, cfg.llm, st, gen, None, max_new_tokens=6, **kw)
    assert bool(st.done.all())
    before = [t.clone() for t in (st.tokens, st.n_gen, st.hist, st.hist_len, st.window,
                                  st.steps, st.accepted)]
    for _ in range(4):
        torch_gen._spec_iteration(tllm, cfg.llm, st, gen, **kw)
    after = (st.tokens, st.n_gen, st.hist, st.hist_len, st.window, st.steps, st.accepted)
    for a, b in zip(before, after):
        assert torch.equal(a, b)


def test_a_state_refuses_knobs_it_was_not_made_for(model):
    cfg, _, tparams, _ = model
    st = _state(tparams["llm"], cfg.llm)
    seq_lens, _, _, prompt_ids = _prompt()
    with pytest.raises(ValueError, match="keep_prob"):
        st.reset(torch.from_numpy(seq_lens), st.logits.clone(), prompt_ids, seq_lens,
                 _torch_stop(NEVER), 0, keep_prob=0.5)
    with pytest.raises(ValueError, match="spec_k >= 1"):
        _torch_spec(model, tparams["llm"], 0, 4)


# ------------------------------------------------------------ graph entries


def _entry(cfg, params, cache=None, hist_width=14, **kw):
    step_kw = dict(spec_k=3, temperature=0.0, do_sample=False, top_p=1.0, pad_id=0,
                   emb_dtype=torch.float32, draft_keep=False, oracle=False)
    step_kw.update(kw)
    return torch_gen._decode_graph(params, cfg, 3, 20, 6, (1, 2), torch.device("cpu"), step_kw,
                                   cache=cache, hist_width=hist_width)


def test_spec_graph_entries_are_keyed_bounded_and_die_with_params_or_cache(model):
    """The spec entries' bookkeeping (no capture on the CPU): a SpecState and
    `_spec_iteration` a key; spec_k, the history's width and the bench's
    knobs in the key; a generator where the run draws (sampled, or drafts
    corrupted, also greedy); the plain loop's entry apart; at most
    MAX_DECODE_GRAPHS; an entry dropped with its params, or with the
    caller's cache, which it holds only weakly."""
    cfg, _, tparams, _ = model
    llm, tllm = cfg.llm, tparams["llm"]
    torch_gen.clear_decode_graphs()
    try:
        first = _entry(llm, tllm)
        assert isinstance(first.state, torch_gen.SpecState)
        assert first.iteration is torch_gen._spec_iteration and first.generator is None
        assert first.state.keep_prob is None and first.state.oracle_ids is None
        assert _entry(llm, dict(tllm)) is first
        keyed = [_entry(llm, tllm, spec_k=4), _entry(llm, tllm, hist_width=15),
                 _entry(llm, tllm, oracle=True)]
        assert first not in keyed and len({id(e) for e in keyed}) == 3
        assert keyed[2].state.oracle_ids.shape == (3, 6)
        corrupt = _entry(llm, tllm, draft_keep=True)
        assert corrupt.generator is not None and corrupt.state.keep_prob is not None
        assert first not in torch_gen.decode_graphs()  # the least recently used went first
        assert len(torch_gen.decode_graphs()) == torch_gen.MAX_DECODE_GRAPHS
        plain = torch_gen._decode_graph(tllm, llm, 3, 20, 6, (1, 2), torch.device("cpu"),
                                        dict(temperature=0.0, do_sample=False, top_p=1.0,
                                             pad_id=0, emb_dtype=torch.float32))
        assert isinstance(plain.state, torch_gen.DecodeState)
        assert plain.iteration is torch_gen._decode_iteration
        torch_gen.clear_decode_graphs()

        copy = jax.tree.map(lambda t: t.clone(), tllm)
        owned = _entry(llm, copy)
        cache = torch_llama.init_cache(llm, 3, 20, dtype=torch.float32, device="cpu")
        over = _entry(llm, tllm, cache=cache)
        assert over.state.cache is cache and owned.state.cache is not cache
        over.state.cache = None  # as decode_with_cache_spec leaves it
        del copy, cache
        gc.collect()
        assert torch_gen.decode_graphs() == []
    finally:
        torch_gen.clear_decode_graphs()
