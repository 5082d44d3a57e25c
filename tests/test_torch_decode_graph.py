"""The port's device-state decode loop against the JAX `generate_tokens`.

`teochat_torch.models.generation` runs the decode loop as one iteration of
fixed-shape tensors, in chunks of DECODE_CHUNK with one host read of `done`
a chunk (on the card the iteration replays from a CUDA graph; here it runs
eagerly, in the same chunks). The tokens and n_gen must be the JAX while
loop's exactly, on the tiny fp32 decoder of test_torch_teochat.py (its
lm_head scaled x40, so reduction-order noise cannot flip an argmax): a
ragged greedy batch of 3, EOS and a 2-token keyword stop inside a chunk, a
row done at its first token, and max_new_tokens 1, 2 and one that is not a
multiple of the chunk; the torch loop runs at DECODE_CHUNK and at chunks of
1, 3 and 4 against the same JAX tokens. One JAX model serves every case, and the cases share
four compilations of the JAX function (the XLA CPU compiler is kept well
below the few hundred a process that it survives).

Also here, without a card: an iteration reads nothing back to the host
(every reading method of torch.Tensor patched to raise), generate records no
autograd graph with trainable leaves, the launch counters' capture and
replay accounting, and the graph entries' keys, bound and lifetime.
"""

import dataclasses
import gc
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from teochat_tpu.config import GenerationConfig, tiny_test_config
from teochat_tpu.constants import IMAGE_TOKEN_INDEX as IMG
from teochat_tpu.models import generation as jax_gen
from teochat_tpu.models import teochat as jax_teochat
from teochat_torch.checkpoint.bridge import to_torch
from teochat_torch.models import generation as torch_gen
from teochat_torch.models import llama as torch_llama
from teochat_torch.models import teochat as torch_teochat
from teochat_torch.ops import _build
from teochat_torch.ops import quant as torch_quant

MAX_NEW = 11  # not a multiple of DECODE_CHUNK: the last chunk is a short one
CHUNKS = sorted({torch_gen.DECODE_CHUNK, 1, 3, 4})
SEQ_LENS = [7, 4, 6]  # a ragged batch of 3, right-padded to S
S = 8
NEVER = 127  # an EOS id the tiny model never picks in these runs (checked)


@pytest.fixture(scope="module")
def model():
    """(JAX llm params, torch llm params, LlamaConfig, prompt embeddings, the
    TEOChatConfig and its whole torch params tree)."""
    cfg = dataclasses.replace(tiny_test_config(vocab_size=128), dtype="float32")
    params = jax_teochat.init_teochat(jax.random.PRNGKey(7), cfg)
    llm = dict(params["llm"])
    llm["lm_head"] = {"kernel": llm["lm_head"]["kernel"] * 40.0}  # well-separated argmax
    params = jax.tree.map(np.asarray, {**params, "llm": llm})
    rs = np.random.RandomState(11)
    ids = rs.randint(3, cfg.llm.vocab_size, size=(len(SEQ_LENS), S))
    embeds = params["llm"]["embed_tokens"]["embedding"][ids].astype(np.float32)
    tparams = to_torch(params, "cpu")
    return params["llm"], tparams["llm"], cfg.llm, embeds, cfg, tparams


def _prompt():
    seq_lens = np.array(SEQ_LENS, np.int32)
    mask = np.arange(S)[None, :] < seq_lens[:, None]
    pos = np.where(mask, np.arange(S)[None, :], 0).astype(np.int32)
    return seq_lens, mask, pos


def _stop(keywords, eos, m=None):
    m = m or max([len(k) for k in keywords] + [1])
    mat = np.zeros((max(len(keywords), 1), m), np.int32)
    lens = np.zeros((mat.shape[0],), np.int32)
    for i, kw in enumerate(keywords):
        mat[i, m - len(kw):] = kw
        lens[i] = len(kw)
    return mat, lens, int(eos)


def _jax(model, max_new, stop):
    jllm, _, cfg, embeds = model[:4]
    seq_lens, mask, pos = _prompt()
    mat, lens, eos = stop
    tokens, n_gen = jax_gen.generate_tokens(
        jllm, cfg, jnp.asarray(embeds), jnp.asarray(seq_lens), jnp.asarray(mask),
        jnp.asarray(pos), None,
        jax_gen.StopSpec(keyword_ids=jnp.asarray(mat), keyword_lens=jnp.asarray(lens),
                         eos_id=jnp.asarray(eos, jnp.int32)),
        jax.random.PRNGKey(0), max_new_tokens=max_new, cache_len=S + max_new + 1)
    return np.asarray(tokens), np.asarray(n_gen)


def _torch(model, max_new, stop, params=None):
    _, tllm, cfg, embeds = model[:4]
    seq_lens, mask, pos = _prompt()
    mat, lens, eos = stop
    tokens, n_gen = torch_gen.generate_tokens(
        tllm if params is None else params, cfg, torch.from_numpy(embeds),
        torch.from_numpy(seq_lens), torch.from_numpy(mask), torch.from_numpy(pos),
        torch_gen.StopSpec(keyword_ids=mat, keyword_lens=lens, eos_id=eos),
        torch.Generator().manual_seed(0), max_new_tokens=max_new, cache_len=S + max_new + 1)
    return tokens.numpy(), n_gen.numpy()


@pytest.fixture(scope="module")
def free_run(model):
    """The JAX tokens of MAX_NEW steps with no stop: the stops below come from them."""
    return _jax(model, MAX_NEW, _stop([], NEVER))


def test_free_running_ragged_batch_matches_jax(model, free_run, monkeypatch):
    want_tokens, want_n = free_run
    assert MAX_NEW % torch_gen.DECODE_CHUNK != 0
    assert (want_n == MAX_NEW).all() and not (want_tokens == NEVER).any()
    for chunk in CHUNKS:
        monkeypatch.setattr(torch_gen, "DECODE_CHUNK", chunk)
        got_tokens, got_n = _torch(model, MAX_NEW, _stop([], NEVER))
        np.testing.assert_array_equal(got_tokens, want_tokens, err_msg=f"chunk {chunk}")
        np.testing.assert_array_equal(got_n, want_n, err_msg=f"chunk {chunk}")
        assert got_tokens.dtype == np.int32 and got_n.dtype == np.int32


@pytest.mark.parametrize("max_new", [1, 2])
def test_short_runs_match_jax(model, free_run, max_new):
    want = _jax(model, max_new, _stop([], NEVER))
    got = _torch(model, max_new, _stop([], NEVER))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(want[0], free_run[0][:, :max_new])


def _stop_cases(free):
    """(name, stop, the n_gen it must give) built from the free-running
    tokens (row 0: 49 2 67 49 67 52 9 ..., row 1: 61 101 9 ..., row 2: 52
    84 99 98 84 99 98 ...); with DECODE_CHUNK 2, a chunk is 2 tokens."""
    return [
        # every row stops inside a chunk (of 2, 3 or 4): row 2 on the keyword
        # 84 99, rows 0 and 1 on EOS 9; the loop ends inside a chunk
        ("inside a chunk", _stop([free[2][1:3]], free[1][2]), [7, 3, 3]),
        # row 2 done at its first token (EOS 52), row 0 on the keyword 2 67,
        # row 1 runs to max_new_tokens
        ("done at step 0", _stop([free[0][1:3]], free[2][0]), [3, MAX_NEW, 1]),
        # EOS alone (the keyword row is empty), at the end of a chunk of 2 or 4
        ("at a chunk's end", _stop([], free[2][3], m=2), [MAX_NEW, MAX_NEW, 4]),
    ]


@pytest.mark.parametrize("case", [0, 1, 2])
def test_eos_and_keyword_stops_match_jax(model, free_run, case, monkeypatch):
    name, stop, n_want = _stop_cases(free_run[0])[case]
    want_tokens, want_n = _jax(model, MAX_NEW, stop)
    for chunk in CHUNKS:
        monkeypatch.setattr(torch_gen, "DECODE_CHUNK", chunk)
        got_tokens, got_n = _torch(model, MAX_NEW, stop)
        np.testing.assert_array_equal(got_tokens, want_tokens, err_msg=f"{name}, chunk {chunk}")
        np.testing.assert_array_equal(got_n, want_n, err_msg=f"{name}, chunk {chunk}")
    np.testing.assert_array_equal(want_n, n_want, err_msg=name)  # what the case is there for
    for row, n in enumerate(want_n):
        assert (want_tokens[row, n:] == 0).all()  # pad_id after the stop


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_an_iteration_reads_nothing_back(model, monkeypatch, quant):
    """One decode iteration and one record with every method that copies a
    tensor's values to the host patched to raise: the step can run as a
    CUDA graph, and a chunk reads `done` once."""
    _, tllm, cfg, embeds = model[:4]
    if quant == "int8":
        tllm = torch_quant.quantize_llama_params(tllm)
    elif quant == "int4":
        tllm = torch_quant.quantize_llama_params_int4(tllm)
    cache = torch_llama.init_cache(cfg, 3, S + 8, dtype=torch.float32, device="cpu")
    st = torch_gen.DecodeState.new(cache, cfg.vocab_size, 6, (1, 2))
    seq_lens, _, _ = _prompt()
    st.reset(torch.from_numpy(seq_lens), torch_gen.StopSpec(*_stop([[5, 6]], 9)), 0)
    logits = torch.randn(3, cfg.vocab_size, generator=torch.Generator().manual_seed(1))
    kw = dict(temperature=0.0, do_sample=False, top_p=1.0, pad_id=0, emb_dtype=torch.float32)

    def refuse(*_a, **_k):
        raise AssertionError("a decode iteration read a tensor back to the host")

    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__",
                 "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    gen = torch.Generator().manual_seed(0)
    torch_gen._record(st, logits, gen, **kw)
    for _ in range(2):
        torch_gen._decode_iteration(tllm, cfg, st, gen, **kw)
    monkeypatch.undo()
    assert int(st.step) == 2 and st.tokens[:, 3:].eq(0).all()


def test_generate_records_no_autograd_graph(model, monkeypatch):
    """With trainable leaves, TEOChat.generate and generate_tokens run under
    no_grad: no forward they make has a grad_fn, nor do their results."""
    _, tllm, cfg, _ = model[:4]
    trainable = jax.tree.map(lambda t: t.clone().requires_grad_(t.is_floating_point()), tllm)
    forward, seen = torch_llama.llama_forward, []

    def spy(*a, **k):
        out = forward(*a, **k)
        seen.append(out.grad_fn)
        return out

    monkeypatch.setattr(torch_llama, "llama_forward", spy)
    tokens, n_gen = _torch(model, 3, _stop([], NEVER), params=trainable)
    assert seen and all(g is None for g in seen)
    assert tokens is not None and n_gen is not None

    tcfg, full = model[4:]
    full = {**full, "llm": trainable}
    full["projector"] = jax.tree.map(lambda t: t.requires_grad_(True), full["projector"])
    seen.clear()
    frames = np.random.RandomState(8).randn(1, 3, 28, 28).astype(np.float32)
    out = torch_teochat.TEOChat(tcfg, full).generate(
        [[1, 5, IMG, 7]], frames, GenerationConfig(max_new_tokens=3, temperature=0.0,
                                                   do_sample=False, stop_strings=()))
    assert seen and all(g is None for g in seen) and len(out[0]) == 3


def test_capture_counts_take_back_and_replays_add():
    a, b = _build.LaunchCounter("test a"), _build.LaunchCounter("test b")
    a.count, b.count = 5, 7
    with _build.capture_counts() as seen:
        a.count += 3
        b.count += 0
    assert seen == {a: 3} and (a.count, b.count) == (5, 7)
    _build.add_counts(seen, 4)
    assert (a.count, b.count) == (17, 7)
    with pytest.raises(RuntimeError), _build.capture_counts() as seen:  # a failed capture
        a.count += 2
        raise RuntimeError("capture failed")
    assert a.count == 17


def _entry(model, params, **kw):
    cfg = model[2]
    step_kw = dict(temperature=0.0, do_sample=False, top_p=1.0, pad_id=0,
                   emb_dtype=torch.float32)
    step_kw.update(kw)
    return torch_gen._decode_graph(params, cfg, 3, 20, 10, (1, 2), torch.device("cpu"), step_kw)


def test_graph_entries_are_keyed_bounded_and_die_with_their_params(model):
    """The entries' bookkeeping (no capture happens here): one entry per key,
    the least recently used dropped past MAX_DECODE_GRAPHS, and an entry
    dropped once the params it was made for are freed."""
    tllm = model[1]
    torch_gen.clear_decode_graphs()
    try:
        first = _entry(model, tllm)
        assert _entry(model, dict(tllm)) is first  # the same leaves where they lay
        assert _entry(model, tllm, temperature=0.5, do_sample=True) is not first
        assert first.generator is None
        assert _entry(model, tllm, temperature=0.5, do_sample=True).generator is not None
        copy = jax.tree.map(lambda t: t.clone(), tllm)
        other = _entry(model, copy)
        assert other is not first and len(torch_gen.decode_graphs()) == 3
        del copy
        gc.collect()
        assert other not in torch_gen.decode_graphs() and len(torch_gen.decode_graphs()) == 2
        kept = [jax.tree.map(lambda t: t.clone(), tllm) for _ in range(torch_gen.MAX_DECODE_GRAPHS)]
        for params in kept:
            _entry(model, params)
        assert len(torch_gen.decode_graphs()) == torch_gen.MAX_DECODE_GRAPHS
        assert first not in torch_gen.decode_graphs()
        assert not first.state.cache.k.any()
    finally:
        torch_gen.clear_decode_graphs()
    assert torch_gen.decode_graphs() == []


def test_captured_entries_set_no_function_attribute_per_launch():
    """K3's M > 8 entry, which a decode step at batch > 8 captures, asks for
    its shared memory once a device, not at every launch."""
    source = (Path(_build.CSRC) / "int4_matmul.cu").read_text()
    large = source[source.index("int launch_large_m("):source.index("int launch(")]
    assert large.count("cudaFuncSetAttribute") == 1
    guarded = re.search(r"if \(!smem_set\[dev\]\) \{\s*const cudaError_t cerr = "
                        r"cudaFuncSetAttribute\(", large)
    assert guarded and "smem_set[dev] = true;" in large
