"""The serving engine's speculative and adaptive mode (teochat_torch/serve/engine.py) on the CPU.

Against the JAX package, on the same fp32 weights (the tiny TEOChat, its
lm_head scaled x40 for a well-separated argmax) made from a seed:
- `_decode_chunk_spec` (`_spec_step` twice) against JAX's program of the
  same name from the same cache and state: a row whose drafts are accepted
  and that emits an EOS inside its block, an inactive row, a row the
  capacity guard stops and a row whose drafts are rejected. Tokens, counts,
  positions, active, hist and hist_len exact; the cache within 1e-5 (the
  trash slot, which no query reads and which an inactive row writes k + 1
  times in one scatter, aside);
- the JAX engine tests' speculative and adaptive cases
  (tests/test_engine.py, tests/test_engine_prefix.py::
  test_prefix_with_speculation), each request's greedy tokens equal to the
  JAX engine's on the same weights and requests;
- the echo model (every layer's out and down projections zero, the lm_head
  the embedding shifted by one token): the greedy next token is the current
  one's successor, so a prompt that holds a run a, a + 1, ..., a + n and then
  its start again is echoed: prompt lookup drafts the run's next k tokens
  and every draft is accepted. Both engines give the same tokens and the
  same counts, k + 1 tokens an iteration.
Then the port's own: `_spec_emissions`' sampled rows against the exact
distribution (the JAX test's distributions, 4,000 torch draws, its bounds),
one iteration with every host read patched to raise, the speculative graph
entry's key and lifetime (no capture), the length check that counts
speculative_k + 1 slots, and the server's `--speculative_k` and /stats.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from teochat_tpu.config import GenerationConfig as JaxGenerationConfig
from teochat_tpu.config import tiny_test_config
from teochat_tpu.models import llama as jax_llama
from teochat_tpu.models import teochat as jax_teochat
from teochat_tpu.serve import engine as jax_engine
from teochat_torch.checkpoint.bridge import to_torch
from teochat_torch.config import GenerationConfig
from teochat_torch.models import generation as torch_gen
from teochat_torch.models import llama as torch_llama
from teochat_torch.models import teochat as torch_teochat
from teochat_torch.serve import engine as engine_mod
from teochat_torch.serve import server as server_mod
from teochat_torch.serve.engine import BatchEngine
from teochat_torch.serve.server import ChatServer
from tests.test_eval_e2e import MockTokenizer
from tests.test_torch_engine import SYSTEM, _chat, _http, _prompts

STATE_TOL = 1e-5  # the cache against JAX's program
GREEDY = dict(temperature=0.0, do_sample=False, stop_strings=())


def _gen(n):
    return GenerationConfig(max_new_tokens=n, **GREEDY)


def _jax_gen(n):
    return JaxGenerationConfig(max_new_tokens=n, **GREEDY)


def _echo(p):
    """The echo model's weights (numpy tree): no layer adds to the residual,
    and the lm_head scores token v by its predecessor's embedding, so the
    greedy successor of t is t + 1. (A lm_head equal to the embedding makes
    t its own successor; prompt lookup then drafts from the most recent
    earlier occurrence of `t t t`, one slot back, and a draft of one token
    is all it finds.)"""
    emb = p["llm"]["embed_tokens"]["embedding"]
    llm = {**p["llm"], "lm_head": {"kernel": np.ascontiguousarray(np.roll(emb, 1, axis=0).T)}}
    layers = llm["layers"]
    llm["layers"] = {
        **layers,
        "attn": {**layers["attn"], "out": {"kernel": np.zeros_like(layers["attn"]["out"]["kernel"])}},
        "mlp": {**layers["mlp"], "down": {"kernel": np.zeros_like(layers["mlp"]["down"]["kernel"])}},
    }
    return {**p, "llm": llm}


@pytest.fixture(scope="module")
def params():
    """The tiny fp32 TEOChat's config and weights (numpy)."""
    cfg = dataclasses.replace(tiny_test_config(vocab_size=128), dtype="float32")
    p = jax_teochat.init_teochat(jax.random.PRNGKey(7), cfg)
    llm = dict(p["llm"])
    llm["lm_head"] = {"kernel": llm["lm_head"]["kernel"] * 40.0}
    return cfg, jax.tree.map(np.asarray, {**p, "llm": llm})


@pytest.fixture(scope="module")
def models(params):
    """(the port's TEOChat, JAX's) on the same weights."""
    cfg, p = params
    return (torch_teochat.TEOChat(cfg, to_torch(p, "cpu"), tokenizer=MockTokenizer()),
            jax_teochat.TEOChat(cfg, p, tokenizer=MockTokenizer()))


@pytest.fixture(scope="module")
def echo_models(params):
    cfg, p = params
    e = _echo(p)
    return (torch_teochat.TEOChat(cfg, to_torch(e, "cpu"), tokenizer=MockTokenizer()),
            jax_teochat.TEOChat(cfg, e, tokenizer=MockTokenizer()))


def _serve(engine_cls, model, prompts, gens, concurrent=True, **kw):
    """Each prompt's tokens through a started engine (threads at once, or one
    after another), and the engine's stats; the engine is shut down."""
    engine = engine_cls(model, **kw).start()
    try:
        if not concurrent:
            return [list(map(int, engine.submit(ids, fr, g)))
                    for (ids, fr), g in zip(prompts, gens)], dict(engine.stats)
        results = [None] * len(prompts)

        def run(i):
            results[i] = list(map(int, engine.submit(prompts[i][0], prompts[i][1], gens[i])))

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        return results, dict(engine.stats)
    finally:
        engine.shutdown()


def _both(models, prompts, n, concurrent=True, **kw):
    """(port tokens, JAX tokens, port stats, JAX stats) of the same requests
    through engines of the same arguments."""
    got, tstats = _serve(BatchEngine, models[0], prompts, [_gen(n)] * len(prompts),
                         concurrent, **kw)
    want, jstats = _serve(jax_engine.BatchEngine, models[1], prompts,
                          [_jax_gen(n)] * len(prompts), concurrent, **kw)
    return got, want, tstats, jstats


# ------------------------------------------------ one chunk against JAX's program

MAX_SLOTS, MAX_LEN, POOL, K, CHUNK = 4, 48, 1, 3, 2


def _state_pair(rs, cfg, fields):
    cache_shape = (cfg.num_layers, MAX_SLOTS + POOL, MAX_LEN, cfg.num_kv_heads, cfg.head_dim)
    k, v = (rs.randn(*cache_shape).astype(np.float32) for _ in range(2))
    jstate = jax_engine._init_engine_state(MAX_SLOTS, MAX_LEN, jax.random.PRNGKey(0))
    jstate.update({n: jnp.asarray(a) for n, a in fields.items()})
    jcache = jax_llama.KVCache(k=jnp.asarray(k), v=jnp.asarray(v))
    tcache = torch_llama.KVCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()))
    tstate = engine_mod._init_engine_state(tcache, MAX_SLOTS, MAX_LEN, CHUNK, K)
    for n, a in fields.items():
        getattr(tstate, n).copy_(torch.from_numpy(a))
    return jcache, jstate, tcache, tstate


def test_spec_chunk_matches_jax(params, models):
    """Two speculative iterations from the same state in both packages. Row
    0's history holds its own greedy continuation after its last three
    tokens, so its drafts are accepted, and EOS is its block's first token
    that differs from the one before: the chain stops there. Row 1 is
    inactive; row 2 starts 3 slots short of the guard and is stopped by it
    in the second iteration; row 3's drafts come from a random history."""
    cfg, p = params
    tllm = models[0].params["llm"]
    rs = np.random.RandomState(5)
    positions = np.array([9, 5, MAX_LEN - K - 2, 20], np.int32)
    hist_len = np.array([11, 3, 10, 12], np.int32)
    hist = np.full((MAX_SLOTS, MAX_LEN), -1, np.int32)
    for r, n in enumerate(hist_len):
        hist[r, :n] = rs.randint(4, 100, n)
    fields = dict(last_tokens=hist[np.arange(MAX_SLOTS), hist_len - 1].copy(),
                  positions=positions, active=np.array([True, False, True, True]),
                  temperature=np.zeros(MAX_SLOTS, np.float32),
                  do_sample=np.zeros(MAX_SLOTS, bool), hist=hist, hist_len=hist_len,
                  adapter=np.full(MAX_SLOTS, -1, np.int32))
    # row 0's greedy continuation, from a plain chunk of the port on a copy
    _, _, _, probe = _state_pair(np.random.RandomState(6), cfg.llm, fields)
    probe_state = engine_mod._init_engine_state(probe.cache, MAX_SLOTS, MAX_LEN, K + 1)
    for n in fields:
        getattr(probe_state, n).copy_(getattr(probe, n))
    g = engine_mod._decode_chunk(tllm, cfg.llm, probe_state, chunk=K + 1, eos_id=-1, pad_id=0,
                                 emb_dtype=torch.float32)[0].tolist()
    a, b, tok = hist[0, 8:11]
    hist[0, :11] = [a, b, tok, *g[:K], 7, 8, a, b, tok]
    fields.update(hist=hist)
    cut = next(j for j in range(1, K + 1) if g[j] != g[0])  # the EOS: inside the block
    eos = g[cut]
    jcache, jstate, tcache, tstate = _state_pair(np.random.RandomState(6), cfg.llm, fields)
    want_t, want_c, jcache, jstate = jax_engine._decode_chunk_spec(
        p["llm"], jcache, jstate, cfg.llm, CHUNK, K, eos, 0)
    got_t, got_c = engine_mod._decode_chunk_spec(tllm, cfg.llm, tstate, chunk=CHUNK, spec_k=K,
                                                 eos_id=eos, pad_id=0, emb_dtype=torch.float32)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert got_c[0, 0] == cut + 1 and got_t[0, 0, cut] == eos and got_c[0, 1] == 0
    assert got_c[1].tolist() == [0, 0] and got_c[2, 0] >= 1 and got_c[2, 1] == 0
    assert tstate.active[:3].tolist() == [False, False, False]
    for n in ("last_tokens", "positions", "active", "hist", "hist_len"):
        np.testing.assert_array_equal(getattr(tstate, n).numpy(), np.asarray(jstate[n]), n)
    jk, jv = np.array(jcache.k), np.array(jcache.v)
    tk, tv = tcache.k.numpy().copy(), tcache.v.numpy().copy()
    for arr in (jk, jv, tk, tv):
        arr[:, :, -1] = 0.0
    np.testing.assert_allclose(tk, jk, rtol=0, atol=STATE_TOL)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=STATE_TOL)


def test_spec_emissions_sampling_exactness():
    """The JAX test's k = 2 block of fixed distributions, 4,000 sampled rows
    at once from one torch generator: slot 0 is distributed as p0, draft 0
    is accepted with probability p0[0], and slot 1 given that as p1."""
    p0 = np.array([0.5, 0.25, 0.15, 0.10])
    p1 = np.array([0.10, 0.20, 0.30, 0.40])
    p2 = np.array([0.25, 0.25, 0.25, 0.25])
    n = 4000
    blk_logits = torch.log(torch.tensor(np.stack([p0, p1, p2]), dtype=torch.float32))
    blk_logits = blk_logits[None].expand(n, 3, 4).contiguous()
    targets = torch.argmax(blk_logits, dim=-1).to(torch.int32)
    drafts = torch.tensor([[0, 3]], dtype=torch.int32).expand(n, 2).contiguous()
    generator = torch.Generator().manual_seed(0)
    match, emit = engine_mod._spec_emissions(blk_logits, targets, drafts,
                                             torch.zeros(n, dtype=torch.bool),
                                             torch.ones(n), generator)
    match, emit = match.numpy(), emit.numpy()
    np.testing.assert_allclose(np.bincount(emit[:, 0], minlength=4) / n, p0, atol=0.03)
    assert abs(match[:, 0].mean() - 0.5) < 0.03
    sel = match[:, 0]
    np.testing.assert_allclose(np.bincount(emit[sel, 1], minlength=4) / sel.sum(), p1, atol=0.04)
    # a greedy row emits the targets, whatever it draws
    _, greedy = engine_mod._spec_emissions(blk_logits[:2], targets[:2], drafts[:2],
                                           torch.ones(2, dtype=torch.bool), torch.zeros(2),
                                           generator)
    assert torch.equal(greedy, targets[:2])


# ------------------------------------- the JAX engine tests' cases, against JAX's engine


def test_engine_speculative_matches_plain(models):
    """tests/test_engine.py's case: concurrent 2-frame requests through a
    speculative engine give the JAX engine's tokens and the port's plain
    generate's."""
    prompts = _prompts(3)
    got, want, stats, _ = _both(models, prompts, 8, max_slots=4, max_len=96, chunk=2,
                                speculative_k=3)
    assert got == want == [models[0].generate([ids], fr, _gen(8))[0] for ids, fr in prompts]
    assert stats["spec_iterations"] > 0


def test_engine_speculative_sampling_rows(models):
    """A greedy row beside a sampled one gives its tokens alone (the JAX
    engine's), and the sampled row ends within its budget."""
    greedy_ids = [1, 9, 12, 4]
    sampling = GenerationConfig(max_new_tokens=6, temperature=1.2, do_sample=True,
                                stop_strings=())
    engine = BatchEngine(models[0], max_slots=2, max_len=96, chunk=2, speculative_k=3).start()
    try:
        alone = engine.submit(greedy_ids, None, _gen(6))
        out = {}
        threads = [threading.Thread(target=lambda: out.update(g=engine.submit(
                       greedy_ids, None, _gen(6)))),
                   threading.Thread(target=lambda: out.update(s=engine.submit(
                       [1, 6, 3, 2, 8], None, sampling)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        engine.shutdown()
    want, _ = _serve(jax_engine.BatchEngine, models[1], [(greedy_ids, None)], [_jax_gen(6)],
                     max_slots=2, max_len=96, chunk=2, speculative_k=3)
    assert out["g"] == alone == want[0]
    assert 1 <= len(out["s"]) <= 6 and all(0 <= t < 128 for t in out["s"])


def test_engine_speculative_no_stall_on_rejected_drafts(models):
    """A sampled row emits a token every iteration even when its drafts are
    rejected: 1 + 8 tokens take at most 3 chunks of 4 iterations."""
    sampling = GenerationConfig(max_new_tokens=9, temperature=1.2, do_sample=True,
                                stop_strings=())
    engine = BatchEngine(models[0], max_slots=1, max_len=96, chunk=4, speculative_k=3).start()
    try:
        out = engine.submit([1, 6, 3, 2, 8], None, sampling)
    finally:
        engine.shutdown()
    assert 1 <= len(out) <= 9 and engine.stats["chunks"] <= 3, engine.stats


def test_engine_soak_slot_recycling(models):
    """16 requests through 2 slots one after another in speculative mode: a
    repeated prompt gives its first answer again, and every answer is the
    JAX engine's."""
    prompts = [([1, 5 + (i % 5), 9, 4 + (i % 3)], None) for i in range(16)]
    got, want, stats, _ = _both(models, prompts, 4, concurrent=False, max_slots=2, max_len=96,
                                chunk=2, speculative_k=3)
    assert got == want and got[15] == got[0]
    assert stats["requests"] == 16


def test_prefix_with_speculation(models):
    """tests/test_engine_prefix.py's case: a prefix hit with speculative
    chunks gives the JAX engine's tokens (and generate's)."""
    rng = np.random.RandomState(3)
    prompts = [([1] + SYSTEM + [-200] + list(rng.randint(4, 100, 2 + i)),
                rng.randn(1, 3, 28, 28).astype(np.float32)) for i in range(2)]
    got, want, stats, jstats = _both(models, prompts, 6, concurrent=False, max_slots=2,
                                     max_len=96, chunk=2, speculative_k=3, prefix_cache_slots=1,
                                     prefix_min_tokens=8)
    assert got == want == [models[0].generate([ids], fr, _gen(6))[0] for ids, fr in prompts]
    assert stats["prefix_hits"] == jstats["prefix_hits"] == 1


def test_adaptive_spec_controller_switches(models):
    """_update_spec_mode: a low rate turns drafting off, a bad probe keeps it
    off (the countdown re-armed), a good one turns it on, and the EMA
    holds it on through one mediocre chunk."""
    engine = BatchEngine(models[0], max_slots=1, max_len=32, speculative_k=4,
                         spec_probe_every=8)
    engine._update_spec_mode(tokens=8, iterations=8)
    assert not engine._spec_on and engine._spec_probe_in == 8
    assert engine.stats["spec_mode_switches"] == 1
    engine._update_spec_mode(tokens=9, iterations=8)
    assert not engine._spec_on and engine._spec_probe_in == 8
    engine._update_spec_mode(tokens=24, iterations=8)
    assert engine._spec_on and engine.stats["spec_mode_switches"] == 2
    engine._update_spec_mode(tokens=24, iterations=8)
    engine._update_spec_mode(tokens=10, iterations=8)
    assert engine._spec_on


def test_adaptive_spec_probe_rearms_at_dispatch(models):
    """A probe re-arms its countdown when it is dispatched: the next chunk
    the pipeline dispatches before the probe's verdict is plain."""
    engine = BatchEngine(models[0], max_slots=1, max_len=32, speculative_k=4,
                         spec_probe_every=3)
    engine._spec_on, engine._spec_probe_in = False, 1
    assert [engine._use_spec() for _ in range(4)] == [True, False, False, True]
    assert engine._spec_probe_in == 3 and engine.stats["spec_probes"] == 2


@pytest.mark.parametrize("probe_every", [1, 2])
def test_adaptive_spec_outputs_exact(models, monkeypatch, probe_every):
    """An adaptive engine that never reaches its threshold gives the plain
    engine's tokens (the JAX plain engine's). With a probe every chunk every
    chunk is a probe; with one every 2 chunks plain and speculative chunks
    take turns in one request."""
    kinds = []
    for name, kind in (("_decode_chunk", "plain"), ("_decode_chunk_spec", "spec")):
        fn = getattr(engine_mod, name)
        monkeypatch.setattr(engine_mod, name,
                            lambda *a, _fn=fn, _k=kind, **kw: kinds.append(_k) or _fn(*a, **kw))
    ids = [([1, 9, 12, 4, 7], None)]
    want, _ = _serve(jax_engine.BatchEngine, models[1], ids, [_jax_gen(14)], max_slots=1,
                     max_len=96, chunk=2)
    got, stats = _serve(BatchEngine, models[0], ids, [_gen(14)], max_slots=1, max_len=96,
                        chunk=2, speculative_k=3, spec_disable_below=5.0,
                        spec_probe_every=probe_every)
    assert got == want
    assert stats["spec_mode_switches"] == 1
    if probe_every == 1:
        assert set(kinds) == {"spec"}
    else:
        assert "plain" in kinds and kinds.count("spec") >= 2, kinds


def _echo_prompt(start, run=40):
    """BOS, a run of `run` successive ids from `start`, then its first three again."""
    return [1] + list(range(start, start + run)) + list(range(start, start + 3))


def test_echo_model_accepts_every_draft(echo_models, monkeypatch):
    """The echo model in both engines, two concurrent streams: the run's
    continuation, the JAX engine's tokens and generate's, and every verify
    iteration of a live row emitting k + 1 tokens."""
    counts = []
    apply = BatchEngine._apply_chunk

    def recorded(self, snapshot, chunk_out):
        if len(chunk_out[0]) == 2:
            counts.append(chunk_out[0][1].numpy().copy())
        return apply(self, snapshot, chunk_out)

    monkeypatch.setattr(BatchEngine, "_apply_chunk", recorded)
    prompts = [(_echo_prompt(20), None), (_echo_prompt(70), None)]
    got, want, stats, _ = _both(echo_models, prompts, 24, max_slots=2, max_len=96, chunk=2,
                                speculative_k=3, adaptive_spec=False)
    assert got == want == [list(range(23, 47)), list(range(73, 97))]
    assert got[0] == echo_models[0].generate([prompts[0][0]], None, _gen(24))[0]
    live = np.concatenate(counts).ravel()
    live = live[live > 0]  # a row's iterations while it is active on the card
    assert len(live) >= 12 and (live == 3 + 1).all(), counts
    assert stats["spec_tokens"] == 4 * stats["spec_iterations"]


# --------------------------------------------------------------- graph safety, the rest


def test_a_spec_step_reads_nothing_back(models, monkeypatch):
    """One speculative iteration with every method that copies a tensor's
    values to the host patched to raise (rows active, inactive, sampled, at
    the guard): the iteration can be captured in a CUDA graph."""
    cfg = models[0].cfg.llm
    cache = torch_llama.init_cache(cfg, MAX_SLOTS + POOL, MAX_LEN, dtype=torch.float32,
                                   device="cpu")
    st = engine_mod._init_engine_state(cache, MAX_SLOTS, MAX_LEN, CHUNK, K)
    st.active.copy_(torch.tensor([True, False, True, True]))
    st.positions.copy_(torch.tensor([5, 0, 9, MAX_LEN - 3], dtype=torch.int32))
    st.hist[:, :6] = torch.tensor([4, 5, 6, 4, 5, 6], dtype=torch.int32)
    st.hist_len.fill_(6)
    st.do_sample[2], st.temperature[2] = True, 0.8

    def refuse(*_a, **_k):
        raise AssertionError("a speculative step read a tensor back to the host")

    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__",
                 "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    for _ in range(CHUNK):
        engine_mod._spec_step(models[0].params["llm"], cfg, st, st.generator, spec_k=K,
                              eos_id=-1, pad_id=0, emb_dtype=torch.float32)
    monkeypatch.undo()
    counts = st.spec_counts
    assert int(st.col) == CHUNK and counts[1].eq(0).all() and counts[3].eq(0).all()
    assert counts[[0, 2]].ge(1).all() and not st.active[3]
    assert st.positions[0] == 5 + counts[0].sum()


def test_spec_graph_entry_is_the_engines_own(models):
    """The speculative step's entry: keyed by spec_k among the step's
    arguments, drawing from the engine's generator, outside the session
    table; shutdown() and clear_decode_graphs() release it and the plain
    one (stand-ins for captured graphs: the entries are made as on the
    card, over CPU tensors, and nothing is captured)."""
    engine = BatchEngine(models[0], max_slots=2, max_len=32, chunk=2, speculative_k=3)
    assert engine._decode_graph(spec=True) is None  # the CPU runs the step eagerly
    engine.device = torch.device("cuda")  # the engine's device decides; its tensors stay here
    spec, plain = engine._decode_graph(spec=True), engine._decode_graph()
    assert engine._decode_graph(spec=True) is spec and engine._spec_graph is spec
    assert spec.iteration is engine_mod._spec_step and plain.iteration is engine_mod._decode_step
    assert spec.step_kw == dict(plain.step_kw, spec_k=3) and "spec_k" not in plain.step_kw
    assert spec.generator is plain.generator is engine._state.generator
    assert spec.state is plain.state is engine._state
    assert spec not in torch_gen.decode_graphs() and plain not in torch_gen.decode_graphs()
    for entry in (spec, plain):
        entry.graph, entry.launches = object(), {"K2m": 1}
    torch_gen.clear_decode_graphs()
    assert spec.graph is None and plain.graph is None and spec.launches == {}
    spec.graph = plain.graph = object()
    engine.shutdown()
    assert engine._graph is None and engine._spec_graph is None
    assert spec.graph is None and plain.graph is None


def test_length_check_counts_the_verify_block(models):
    """A request fits when prompt + max_new_tokens + speculative_k + 1 slots
    fit max_len (the JAX engine's check): an admitted row never reaches the
    capacity guard."""
    ids = list(range(4, 24))  # 20 tokens
    plain = BatchEngine(models[0], max_slots=1, max_len=32)
    spec = BatchEngine(models[0], max_slots=1, max_len=32, speculative_k=4)
    plain._make_request(ids, None, _gen(11))  # 20 + 11 + 1 = 32
    spec._make_request(ids, None, _gen(7))  # 20 + 7 + 4 + 1 = 32
    with pytest.raises(ValueError, match="exceeds engine max_len"):
        spec._make_request(ids, None, _gen(8))
    jspec = jax_engine.BatchEngine(models[1], max_slots=1, max_len=32, speculative_k=4)
    jspec._make_request(ids, None, _jax_gen(7))
    with pytest.raises(ValueError, match="exceeds engine max_len"):
        jspec._make_request(ids, None, _jax_gen(8))


def test_server_builds_a_speculative_engine_and_reports_its_rate(models, monkeypatch):
    """`--continuous_batching --speculative_k 4` builds the engine with k 4;
    /stats of a speculative engine carries spec_mean_tokens_per_step."""
    built = {}

    class Stub:
        def __init__(self, *a, **kw):
            built.update(kw)

        def start(self):
            return self

    from teochat_torch import utils as utils_mod
    from teochat_torch.serve import chat as chat_mod

    monkeypatch.setattr(utils_mod, "resolve_device", lambda d: torch.device("cpu"))
    monkeypatch.setattr(chat_mod, "Chat", lambda *a, **k: type("C", (), {"model": None})())
    monkeypatch.setattr(engine_mod, "BatchEngine", Stub)
    monkeypatch.setattr(server_mod, "ChatServer", lambda *a, **k: type(
        "S", (), {"serve_forever": lambda self: None})())
    server_mod.main(["--model_path", "unused", "--continuous_batching", "--speculative_k", "4",
                     "--max_slots", "8"])
    assert built["speculative_k"] == 4 and built["max_slots"] == 8
    monkeypatch.undo()

    engine = BatchEngine(models[0], max_slots=2, max_len=64, chunk=2, speculative_k=3).start()
    srv = ChatServer(_chat(models[0]), host="127.0.0.1", port=0, engine=engine).start_background()
    try:
        port = srv._httpd.server_address[1]
        code, out = _http(port, "/generate", {"prompt": "Describe.", "images": [],
                                              "temperature": 0.0, "max_new_tokens": 8})
        assert code == 200 and isinstance(out["response"], str)
        code, stats = _http(port, "/stats")
    finally:
        srv.shutdown()
        engine.shutdown()
    assert code == 200 and stats["spec_iterations"] > 0
    assert stats["spec_mean_tokens_per_step"] == round(
        stats["spec_tokens"] / stats["spec_iterations"], 3)
