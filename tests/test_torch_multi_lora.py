"""Multi-LoRA and LoRA checkpoints of the port against the JAX package, on the CPU.

The port's `train/lora.py` (`stack_lora_adapters`, `adapter_route`,
`num_stacked_adapters`, a LoRA lm_head), `_proj`'s adapter-stacked branch
and the route threaded through `llama_forward`, generate, speculation and
the serving engine, the peft converters (`attach_lora_to_llama`,
`merge_lora_into_llama`), `builder.load_multi_lora` and the server's
`--lora_paths`, held to tests/test_multi_lora.py's JAX twins on the tiny
fp32 TEOChat (lm_head x40 for a well-separated argmax), three rank-4
adapters with B drawn nonzero from numpy seeds:

- the stacked tree equals JAX's leaf for leaf; the route equals JAX's, an
  all-zero row for -1 and for ids >= A;
- `_proj` stacked against JAX's (fp32 1e-5, bf16 to the bf16 step), the
  forward with a mixed route within RTOL / ATOL of JAX's;
- a one-hot row BITWISE the single-adapter model and a -1 row the base
  model, at the same batch shape, over fp32, bf16, int8 and fused int4
  bases;
- generate(adapters=), plain and speculative, JAX's tokens; the engine's
  tokens the single models' generate's; the prefix pool keyed by adapter;
- the converters: attach against JAX's tree, merge byte-equal to JAX's on
  fp16 kernels, attach's forward against merge's; load_multi_lora over a
  fused int4 base against JAX's;
- a LoRA lm_head (ROADMAP F6): the port's unmerged forward equals JAX's
  forward on `merge_lora(params)`, and JAX's unmerged forward where B = 0;
- branch A of the builder (a `teochat-lora` dir over a base, merged and
  `load_8bit`) against the JAX builder's tree;
- `--lora_paths` through the server's entry point and `ChatServer` on an
  ephemeral port.

The JAX side is held to about fifteen compilations (module-scoped trees,
one jitted forward).
"""

import dataclasses
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from teochat_tpu import builder as jax_builder
from teochat_tpu.checkpoint import convert_hf as jax_convert
from teochat_tpu.config import GenerationConfig as JaxGenerationConfig
from teochat_tpu.config import tiny_test_config
from teochat_tpu.models import llama as jax_llama
from teochat_tpu.models import teochat as jax_teochat
from teochat_tpu.ops import quant as jax_quant
from teochat_tpu.train import lora as jax_lora
from teochat_torch import builder as torch_builder
from teochat_torch.checkpoint import convert_hf as torch_convert
from teochat_torch.checkpoint.bridge import to_numpy, to_torch
from teochat_torch.config import GenerationConfig
from teochat_torch.constants import IMAGE_TOKEN_INDEX
from teochat_torch.data.processing import ImageProcessor
from teochat_torch.models import llama as torch_llama
from teochat_torch.models import teochat as torch_teochat
from teochat_torch.ops import quant as torch_quant
from teochat_torch.serve import chat as chat_mod
from teochat_torch.serve import server as server_mod
from teochat_torch.serve.engine import BatchEngine
from teochat_torch.serve.server import ChatServer
from teochat_torch.train import lora as torch_lora
from tests.test_eval_e2e import MockTokenizer

RANK = 4
N_ADAPTERS = 3
RTOL, ATOL = 1e-4, 1e-5  # fp32 logits against JAX's (tests/test_torch_llama.py)
MERGED_REL = 1e-5  # an unmerged fp32 forward against a merged one, of the largest |logit|
GREEDY = dict(temperature=0.0, do_sample=False, stop_strings=())
ROWS = [[1, 5, IMAGE_TOKEN_INDEX, 9, 4], [1, 7, IMAGE_TOKEN_INDEX, 3, 2]]
_jax_forward = jax.jit(jax_llama.llama_forward, static_argnames=("cfg",))


def _gen(n, **kw):
    return GenerationConfig(max_new_tokens=n, **GREEDY, **kw)


def _jax_gen(n, **kw):
    return JaxGenerationConfig(max_new_tokens=n, **GREEDY, **kw)


def _randomize_lora(llm, seed):
    """The zero-init B matrices drawn nonzero, so each adapter changes outputs."""
    rng = np.random.RandomState(seed)

    def go(tree):
        return {k: (go(v) if isinstance(v, dict) else
                    (rng.randn(*v.shape).astype(np.float32) * 0.5 if k == "lora_b" else v))
                for k, v in tree.items()}
    return go(llm)


@pytest.fixture(scope="module")
def setup():
    """(cfg, numpy params, numpy adapter trees, JAX's stacked tree, the
    port's: base, adapters, stacked), all fp32."""
    cfg = dataclasses.replace(tiny_test_config(vocab_size=128), dtype="float32")
    p = jax.tree.map(np.asarray, jax_teochat.init_teochat(jax.random.PRNGKey(7), cfg))
    p["llm"]["lm_head"] = {"kernel": p["llm"]["lm_head"]["kernel"] * 40.0}
    adapters = [
        _randomize_lora(jax.tree.map(np.asarray, jax_lora.add_lora_params(
            jax.random.PRNGKey(i + 1), p["llm"], rank=RANK, alpha=2.0 * RANK)), seed=10 + i)
        for i in range(N_ADAPTERS)]
    multi_j = jax.tree.map(np.asarray, jax_lora.stack_lora_adapters(adapters))
    base_t = to_torch(p["llm"], "cpu")
    adapters_t = [to_torch(a, "cpu") for a in adapters]
    return cfg, p, adapters, multi_j, base_t, adapters_t, torch_lora.stack_lora_adapters(adapters_t)


def _x(cfg, b, s, seed):
    rs = np.random.RandomState(seed)
    return rs.randn(b, s, cfg.llm.hidden_size).astype(np.float32), np.tile(np.arange(s), (b, 1))


def _jax_fwd(llm, cfg, x, pos, route=None):
    logits, _ = _jax_forward(llm, cfg.llm, jnp.asarray(x), position_ids=jnp.asarray(pos),
                             attention_mask=jnp.ones(x.shape[:2], bool), adapter_route=route)
    return np.asarray(logits)


@torch.no_grad()
def _torch_fwd(llm, cfg, x, pos, route=None):
    x = torch.as_tensor(x)
    return torch_llama.llama_forward(llm, cfg.llm, x, position_ids=torch.as_tensor(pos),
                                     attention_mask=torch.ones(x.shape[:2], dtype=torch.bool),
                                     adapter_route=route)


# ------------------------------------------------------------ train/lora.py


def test_stacking_matches_jax(setup):
    """Shapes, count and every leaf of the stacked tree as JAX's; the base
    leaves are the first tree's; a rank mismatch raises."""
    cfg, p, adapters, multi_j, base_t, adapters_t, multi_t = setup
    q = multi_t["layers"]["attn"]["q"]
    L = cfg.llm.num_layers
    assert q["lora_a"].shape[:2] == q["lora_b"].shape[:2] == (L, N_ADAPTERS)
    assert q["lora_scale"].shape == (L, N_ADAPTERS)
    assert torch_lora.num_stacked_adapters(multi_t) == N_ADAPTERS
    assert torch_lora.num_stacked_adapters(base_t) == torch_lora.num_stacked_adapters(
        adapters_t[0]) == 0
    assert q["kernel"] is adapters_t[0]["layers"]["attn"]["q"]["kernel"]
    got, want = to_numpy(multi_t), multi_j
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # the bridge carries the stacked leaves [L, A, ...] as they are
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(to_numpy(to_torch(multi_j, "cpu"))), jax.tree.leaves(multi_j)))
    other = torch_lora.add_lora_params(torch.Generator().manual_seed(9), base_t, rank=2 * RANK)
    with pytest.raises(ValueError, match="rank"):
        torch_lora.stack_lora_adapters([adapters_t[0], other])
    with pytest.raises(ValueError, match="at least one"):
        torch_lora.stack_lora_adapters([])


@pytest.mark.parametrize("ids", [[1, -1, 0], [2, 3, 7, -1, -5]])
def test_adapter_route_matches_jax(ids):
    """One-hot rows; -1 and ids >= A all-zero rows, as JAX's one_hot gives."""
    got = torch_lora.adapter_route(torch.tensor(ids), N_ADAPTERS)
    assert got.dtype == torch.float32 and got.shape == (len(ids), N_ADAPTERS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_lora.adapter_route(ids, N_ADAPTERS)))
    np.testing.assert_array_equal(torch_lora.adapter_route(ids, N_ADAPTERS).numpy(), got.numpy())


def test_add_lora_params_with_a_head_matches_jax_shapes(setup):
    """include_lm_head=True: the head's adapter beside the decoder's, in JAX's
    shapes and dtypes; merge_lora folds it into the head's kernel."""
    cfg, p, _, _, base_t, _, _ = setup
    got = torch_lora.add_lora_params(torch.Generator().manual_seed(0), base_t, rank=RANK,
                                     include_lm_head=True)
    want = jax_lora.add_lora_params(jax.random.PRNGKey(0), p["llm"], rank=RANK,
                                    include_lm_head=True)
    for path in (("lm_head",), ("layers", "mlp", "down")):
        g, w = got, want
        for k in path:
            g, w = g[k], w[k]
        assert sorted(g) == sorted(w)
        for k in g:
            assert tuple(g[k].shape) == tuple(w[k].shape), (path, k)
            assert str(g[k].dtype).split(".")[-1] == str(w[k].dtype), (path, k)
    assert torch.equal(got["lm_head"]["lora_b"], torch.zeros(RANK, cfg.llm.vocab_size))
    merged = torch_lora.merge_lora(got)
    assert set(merged["lm_head"]) == {"kernel"}
    torch.testing.assert_close(merged["lm_head"]["kernel"], base_t["lm_head"]["kernel"],
                               rtol=0, atol=0)


# ------------------------------------------------------------- the forward


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_proj_stacked_matches_jax(setup, dtype):
    """`_proj` over one layer's stacked q with the route [0, 2, -1, 1]
    against JAX's: fp32 within 1e-5; bf16 (both round x a to bf16 and the
    weighted fp32 sum once) to one bf16 step of the largest |y|."""
    cfg, _, _, multi_j, _, _, _ = setup
    layer = {k: v[1] for k, v in multi_j["layers"]["attn"]["q"].items()}
    ids = [0, 2, -1, 1]
    x = np.random.RandomState(3).randn(4, 5, cfg.llm.hidden_size).astype(np.float32)
    jt = getattr(jnp, dtype)
    want = np.asarray(jax_llama._proj(
        jnp.asarray(x, jt), jax.tree.map(jnp.asarray, layer),
        route=jax_lora.adapter_route(ids, N_ADAPTERS)).astype(jnp.float32))
    got = torch_llama._proj(torch.from_numpy(x).to(getattr(torch, dtype)),
                            to_torch(layer, "cpu"), route=torch_lora.adapter_route(ids, N_ADAPTERS))
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_forward_mixed_route_matches_jax(setup):
    """Adapters 0, 2 and the base model in one batch, against JAX's forward
    on the same route; each row differs from the others' models."""
    cfg, _, _, multi_j, _, _, multi_t = setup
    x, pos = _x(cfg, 3, 6, seed=2)
    ids = [0, 2, -1]
    want = _jax_fwd(multi_j, cfg, x, pos, jax_lora.adapter_route(ids, N_ADAPTERS))
    got = _torch_fwd(multi_t, cfg, x, pos, torch_lora.adapter_route(ids, N_ADAPTERS))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    other = _torch_fwd(multi_t, cfg, x, pos, torch_lora.adapter_route([1, 1, 1], N_ADAPTERS))
    assert all((other[i] - got[i]).abs().max() > 1e-2 for i in range(3))


def test_stacked_params_without_a_route_raise(setup):
    cfg, _, _, _, _, _, multi_t = setup
    x, pos = _x(cfg, 1, 4, seed=0)
    with pytest.raises(ValueError, match="adapter_route"):
        _torch_fwd(multi_t, cfg, x, pos)


def _fake_peft_sd(cfg, rank, seed, dtype=torch.float32):
    """A peft-layout adapter state dict (tests/test_multi_lora.py::_fake_peft_dir's)."""
    rng = np.random.RandomState(seed)
    d, i_sz = cfg.llm.hidden_size, cfg.llm.intermediate_size
    hkv = cfg.llm.num_kv_heads * cfg.llm.head_dim
    widths = {"self_attn.q_proj": (d, d), "self_attn.k_proj": (d, hkv),
              "self_attn.v_proj": (d, hkv), "self_attn.o_proj": (d, d),
              "mlp.gate_proj": (d, i_sz), "mlp.up_proj": (d, i_sz), "mlp.down_proj": (i_sz, d)}
    sd = {}
    for layer in range(cfg.llm.num_layers):
        for mod, (fi, fo) in widths.items():
            pre = f"base_model.model.model.layers.{layer}.{mod}"
            sd[f"{pre}.lora_A.weight"] = torch.from_numpy(
                (rng.randn(rank, fi) * 0.1).astype(np.float32)).to(dtype)
            sd[f"{pre}.lora_B.weight"] = torch.from_numpy(
                (rng.randn(fo, rank) * 0.1).astype(np.float32)).to(dtype)
    return sd


def _write_peft_dir(path, sd, rank, alpha=None):
    from safetensors.torch import save_file

    os.makedirs(path, exist_ok=True)
    save_file({k: v.contiguous() for k, v in sd.items()},
              os.path.join(path, "adapter_model.safetensors"))
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": rank, "lora_alpha": alpha or 2 * rank}, f)
    return str(path)


BASES = ["float32", "bfloat16", "bfloat16 int8", "bfloat16 int4"]


def _base_of(setup, base):
    """The port's base decoder: fp32, bf16, or bf16 with int8 or fused int4 projections."""
    cfg, _, _, _, base_t, _, _ = setup
    dtype, _, quant = base.partition(" ")
    tree = to_torch(to_numpy(base_t), "cpu", dtype=getattr(torch, dtype))
    if quant == "int8":
        tree = torch_quant.quantize_llama_params(tree)
    elif quant == "int4":
        tree = torch_quant.quantize_llama_params_int4(tree)
        assert "qkv" in tree["layers"]["attn"] and "gateup" in tree["layers"]["mlp"]
    return tree, getattr(torch, dtype)


@pytest.mark.parametrize("base", BASES)
def test_route_rows_are_bitwise_the_single_adapter_and_the_base(setup, base):
    """Two adapters attached from peft state dicts over one base, stacked: a
    batch routed [0, 1, -1, 1] gives, row for row, BITWISE the logits of
    each single-adapter model and of the base model on the same batch (the
    same batch shape: the hazard is across shapes, not rows)."""
    cfg = setup[0]
    tree, dtype = _base_of(setup, base)
    singles = [torch_convert.attach_lora_to_llama(tree, _fake_peft_sd(cfg, RANK, 30 + i),
                                                  cfg.llm, rank=RANK, alpha=2 * RANK)
               for i in range(2)]
    multi = torch_lora.stack_lora_adapters(singles)
    x, pos = _x(cfg, 4, 5, seed=6)
    x = torch.from_numpy(x).to(dtype)
    ids = [0, 1, -1, 1]
    got = _torch_fwd(multi, cfg, x, pos, torch_lora.adapter_route(ids, 2))
    models = {0: singles[0], 1: singles[1], -1: tree}
    for row, a in enumerate(ids):
        want = _torch_fwd(models[a], cfg, x, pos)
        assert torch.equal(got[row], want[row]), (base, row, a)
    assert not torch.equal(got[0], got[2]) and not torch.equal(got[0], got[1])


def test_lora_head_follows_the_merged_jax_forward(setup):
    """ROADMAP F6: JAX's forward never reads an lm_head adapter, yet its
    merge_lora folds one. The port adds the head's delta to the fp32
    logits: its unmerged forward equals JAX's forward on merge_lora(params),
    and JAX's unmerged forward where the head's B is 0."""
    cfg, p, adapters, _, _, _, _ = setup
    with_head = jax.tree.map(np.asarray, jax_lora.add_lora_params(
        jax.random.PRNGKey(5), p["llm"], rank=RANK, include_lm_head=True))
    x, pos = _x(cfg, 2, 5, seed=9)
    zero_b = _torch_fwd(to_torch(with_head, "cpu"), cfg, x, pos)
    np.testing.assert_allclose(zero_b.numpy(), _jax_fwd(with_head, cfg, x, pos), rtol=RTOL,
                               atol=ATOL)
    drawn = _randomize_lora(with_head, seed=4)
    got = _torch_fwd(to_torch(drawn, "cpu"), cfg, x, pos)
    merged = jax.tree.map(np.asarray, jax_lora.merge_lora(jax.tree.map(jnp.asarray, drawn)))
    want = _jax_fwd(merged, cfg, x, pos)
    # the merge rounds W + delta to fp32 where the port adds x a b to the
    # logits: the two differ at fp32's step of the logits (x40 here)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MERGED_REL * np.abs(want).max())
    unmerged = _jax_fwd(drawn, cfg, x, pos)
    assert np.abs(got.numpy() - unmerged).max() > 1e-2  # the head's delta JAX's forward drops


# --------------------------------------------------- generate and the engine


@pytest.fixture(scope="module")
def models(setup):
    """(JAX's multi-LoRA TEOChat, the port's, the port's single-adapter and base models)."""
    cfg, p, _, multi_j, base_t, adapters_t, multi_t = setup
    tok = MockTokenizer()
    tparams = to_torch({k: v for k, v in p.items() if k != "llm"}, "cpu")
    return (jax_teochat.TEOChat(cfg, {**p, "llm": multi_j}, tokenizer=tok),
            torch_teochat.TEOChat(cfg, {**tparams, "llm": multi_t}, tokenizer=tok),
            {a: torch_teochat.TEOChat(cfg, {**tparams, "llm": t}, tokenizer=tok)
             for a, t in [(-1, base_t)] + list(enumerate(adapters_t))})


def _frames(n, seed):
    return np.random.RandomState(seed).randn(n, 3, 28, 28).astype(np.float32)


@pytest.mark.parametrize("spec_k", [0, 3])
def test_generate_adapters_match_jax(models, spec_k):
    """TEOChat.generate(adapters=[0, 2]) plain and speculative: JAX's tokens,
    and each row the single-adapter model's generate at the same batch shape."""
    jm, tm, singles = models
    frames = _frames(2, seed=3)
    want = jm.generate(ROWS, frames, _jax_gen(6, speculative_k=spec_k), adapters=[0, 2])
    got = tm.generate(ROWS, frames, _gen(6, speculative_k=spec_k), adapters=[0, 2])
    assert got == want
    for row, a in enumerate([0, 2]):
        assert got[row] == singles[a].generate(ROWS, frames, _gen(6, speculative_k=spec_k))[row]
    # a -1 row is the base model's
    assert tm.generate(ROWS, frames, _gen(6), adapters=[-1, 1])[0] == \
        singles[-1].generate(ROWS, frames, _gen(6))[0]


def test_graph_entries_are_keyed_by_the_route_width(setup):
    """A routed call and an unrouted one with every other part of the key
    equal take two entries, the routed one with a [B, A] route buffer in its
    state; a route of another shape than the state's raises (bookkeeping
    only: no capture on the CPU)."""
    from teochat_torch.models import generation as torch_gen

    cfg, _, _, _, _, _, multi_t = setup
    step_kw = dict(temperature=0.0, do_sample=False, top_p=1.0, pad_id=0,
                   emb_dtype=torch.float32)
    torch_gen.clear_decode_graphs()
    try:
        def entry(n):
            return torch_gen._decode_graph(multi_t, cfg.llm, 2, 20, 10, (1, 2),
                                           torch.device("cpu"), step_kw, n_adapters=n)

        routed, plain = entry(N_ADAPTERS), entry(0)
        assert routed is not plain and entry(N_ADAPTERS) is routed
        assert routed.state.route.shape == (2, N_ADAPTERS) and plain.state.route is None
        stop = torch_gen.StopSpec(np.zeros((1, 2), np.int32), np.zeros((1,), np.int32), 2)
        lens = torch.tensor([3, 4])
        for route in (None, torch_lora.adapter_route([0, 1], N_ADAPTERS - 1)):
            with pytest.raises(ValueError, match="adapter_route"):
                routed.state.reset(lens, stop, 0, route)
        routed.state.reset(lens, stop, 0, torch_lora.adapter_route([2, -1], N_ADAPTERS))
        assert routed.state.route.tolist() == [[0, 0, 1], [0, 0, 0]]
    finally:
        torch_gen.clear_decode_graphs()


def test_generate_adapters_on_plain_params_raise(models):
    _, _, singles = models
    with pytest.raises(ValueError, match="adapter"):
        singles[-1].generate([[1, 5, 9]], None, _gen(2), adapters=[0])


def test_engine_routes_each_request(models):
    """Requests of adapters 0, 2 and -1 decode together in one engine, plain
    and speculative: each gives its own model's generate; an adapter out of
    range is refused, and any adapter over plain params."""
    _, tm, singles = models
    prompts = [(ROWS[0], _frames(1, 40)), (ROWS[1] + [8], _frames(1, 41)), ([1, 2, 6], None)]
    ids = [0, 2, -1]
    want = [singles[a].generate([r], f, _gen(5))[0] for (r, f), a in zip(prompts, ids)]
    for spec_k in (0, 4):
        engine = BatchEngine(tm, max_slots=3, max_len=64, chunk=2, speculative_k=spec_k).start()
        try:
            results = [None] * 3

            def run(i):
                results[i] = engine.submit(*prompts[i], _gen(5), adapter=ids[i])
            threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert results == want, spec_k
            assert engine.stats["max_concurrent"] >= 2
            with pytest.raises(ValueError, match="out of range"):
                engine.submit([1, 5], None, _gen(1), adapter=N_ADAPTERS)
        finally:
            engine.shutdown()
    with pytest.raises(ValueError, match="stacked LoRA"):
        BatchEngine(singles[0], max_slots=1, max_len=32)._make_request(
            [1, 5], None, _gen(1), adapter=0)


def test_prefix_pool_is_keyed_by_adapter(models):
    """A prefix pooled under adapter 0 does not seed an adapter-1 request
    (its K/V hold adapter 0's deltas); a second adapter-0 request hits it.
    Every answer is its single-adapter model's."""
    _, tm, singles = models
    shared = [1] + list(range(40, 60))

    def prompt(i):
        return shared + [100 + i, 5]

    engine = BatchEngine(tm, max_slots=2, max_len=64, chunk=2, prefix_cache_slots=2,
                         prefix_min_tokens=8).start()
    try:
        got = [engine.submit(prompt(0), None, _gen(4), adapter=0)]
        assert engine.stats["prefix_hits"] == 0
        got.append(engine.submit(prompt(1), None, _gen(4), adapter=1))
        assert engine.stats["prefix_hits"] == 0
        got.append(engine.submit(prompt(2), None, _gen(4), adapter=0))
        assert engine.stats["prefix_hits"] == 1
    finally:
        engine.shutdown()
    for i, (a, out) in enumerate(zip([0, 1, 0], got)):
        assert out == singles[a].generate([prompt(i)], None, _gen(4))[0], i


# -------------------------------------------------------------- converters


def test_attach_and_merge_match_jax(setup):
    """attach_lora_to_llama: JAX's leaves exactly (fp32 adapters, zero
    adapters for absent layers); merge_lora_into_llama on fp16 kernels:
    JAX's bytes, the input untouched; on bf16 kernels JAX's fp32 merge of
    the widened kernels, rounded to bf16; the attached forward within 2e-3 of
    the merged one (the merge rounds to fp16), as JAX's test holds."""
    cfg, p, _, _, base_t, _, _ = setup
    sd = _fake_peft_sd(cfg, RANK, seed=0)
    del sd["base_model.model.model.layers.1.mlp.up_proj.lora_A.weight"]
    del sd["base_model.model.model.layers.1.mlp.up_proj.lora_B.weight"]
    sd_np = {k: v.numpy() for k, v in sd.items()}
    got = torch_convert.attach_lora_to_llama(base_t, sd, cfg.llm, rank=RANK, alpha=3 * RANK)
    want = jax_convert.attach_lora_to_llama(p["llm"], sd_np, cfg.llm, rank=RANK, alpha=3 * RANK)
    for g, w in zip(jax.tree.leaves(to_numpy(got)), jax.tree.leaves(jax.tree.map(np.asarray, want))):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert not got["layers"]["mlp"]["up"]["lora_a"][1].any()

    fp16 = jax.tree.map(lambda a: a.astype(np.float16), p["llm"])
    before = to_torch(fp16, "cpu")
    host = to_torch(fp16, "cpu")
    merged_t = torch_convert.merge_lora_into_llama(host, sd, cfg.llm, rank=RANK, alpha=3 * RANK)
    merged_j = jax_convert.merge_lora_into_llama(fp16, sd_np, cfg.llm, rank=RANK, alpha=3 * RANK)
    for name in ("q", "out"):
        k = merged_t["layers"]["attn"][name]["kernel"]
        assert k.dtype == torch.float16
        np.testing.assert_array_equal(k.view(torch.int16).numpy(),
                                      merged_j["layers"]["attn"][name]["kernel"].view(np.int16))
    for g, w in zip(jax.tree.leaves(to_numpy(merged_t)), jax.tree.leaves(merged_j)):
        np.testing.assert_array_equal(g, w.astype(np.float32))
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(before)))
    # bf16 kernels: JAX widens them to fp32 and merges there; the port rounds
    # that fp32 sum to bf16 once, where the JAX loader casts it
    bf16 = to_torch(p["llm"], "cpu", dtype=torch.bfloat16)
    merged_b = torch_convert.merge_lora_into_llama(bf16, sd, cfg.llm, rank=RANK, alpha=3 * RANK)
    merged_w = jax_convert.merge_lora_into_llama(to_numpy(bf16), sd_np, cfg.llm, rank=RANK,
                                                 alpha=3 * RANK)
    for name in ("q", "down"):
        group = "mlp" if name == "down" else "attn"
        np.testing.assert_array_equal(
            merged_b["layers"][group][name]["kernel"].view(torch.int16).numpy(),
            torch.from_numpy(merged_w["layers"][group][name]["kernel"]).bfloat16()
            .view(torch.int16).numpy())

    x, pos = _x(cfg, 1, 4, seed=3)
    full = torch_convert.attach_lora_to_llama(base_t, sd, cfg.llm, rank=RANK, alpha=3 * RANK)
    merged32 = torch_convert.merge_lora_into_llama(base_t, sd, cfg.llm, rank=RANK, alpha=3 * RANK)
    np.testing.assert_allclose(_torch_fwd(full, cfg, x, pos).numpy(),
                               _torch_fwd(merged32, cfg, x, pos).numpy(), rtol=2e-3, atol=2e-3)


def test_load_multi_lora_over_fused_int4_matches_jax(setup, tmp_path):
    """load_multi_lora over a fused int4 backbone (q|k|v and gate|up): the
    block-composed adapters (rank 3r, 2r) route per row, and the logits
    match JAX's load_multi_lora on JAX's int4 tree; the model shares every
    base tensor."""
    cfg, p, _, _, _, _, _ = setup
    dirs = [_write_peft_dir(tmp_path / f"ad{i}", _fake_peft_sd(cfg, RANK, 30 + i), RANK)
            for i in range(2)]
    q4 = jax.tree.map(np.asarray, jax_quant.quantize_llama_params_int4(p["llm"]))
    jm = jax_builder.load_multi_lora(jax_teochat.TEOChat(cfg, {**p, "llm": q4}), dirs)
    base = torch_teochat.TEOChat(cfg, to_torch({**p, "llm": q4}, "cpu"))
    tm = torch_builder.load_multi_lora(base, dirs)
    llm = tm.params["llm"]
    assert torch_lora.num_stacked_adapters(llm) == 2
    assert llm["layers"]["attn"]["qkv"]["lora_a"].shape[-1] == 3 * RANK
    assert llm["layers"]["mlp"]["gateup"]["lora_a"].shape[-1] == 2 * RANK
    assert llm["layers"]["attn"]["qkv"]["packed"] is base.params["llm"]["layers"]["attn"]["qkv"]["packed"]
    assert llm["layers"]["attn"]["qkv"]["lora_b"].dtype == torch.float32
    x, pos = _x(cfg, 3, 4, seed=6)
    ids = [0, 1, -1]
    want = _jax_fwd(jax.tree.map(np.asarray, jm.params["llm"]), cfg, x, pos,
                    jax_lora.adapter_route(ids, 2))
    got = _torch_fwd(llm, cfg, x, pos, torch_lora.adapter_route(ids, 2))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    with pytest.raises(FileNotFoundError, match="adapter_model"):
        torch_builder.load_multi_lora(base, [str(tmp_path)])


# ----------------------------------------------------------------- branch A

BF16_TIE = 1e-2  # two bf16 paths' logits within this of the larger may swap (test_torch_fp8_kv.py)


@pytest.fixture(scope="module")
def branch_a(tmp_path_factory):
    """A tiny base checkpoint and a `teochat-lora` dir over it (the builder
    tests' writers), and both packages' load_config with the tiny tower."""
    from tests import test_torch_builder as tb

    root = tmp_path_factory.mktemp("branch_a")
    base_sd = {k: v for k, v in tb.tiny_state_dict().items() if "mm_projector" not in k}
    dirs = (tb.write_lora_dir(root / "teochat-lora", seed=5),
            tb.write_checkpoint(root / "base", base_sd, n_shards=1))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_builder, "load_config", tb._tiny_tower_config(jax_builder.load_config))
        mp.setattr(torch_builder, "load_config", tb._tiny_tower_config(torch_builder.load_config))
        yield tb, dirs


@pytest.mark.parametrize("load_8bit", [False, True])
def test_branch_a_matches_the_jax_builder(branch_a, load_8bit):
    """load_pretrained_model(lora_dir, base): the config and tokenizer from
    the LoRA dir, the projector and embed rows from its
    non_lora_trainables.bin, the adapter merged on the host (before the
    int8 quantization): JAX's tree exactly, the prefill logits within the
    builder tests' 1 % and greedy tokens equal, or parting first where both
    packages' logits hold the two tokens as their top two within BF16_TIE."""
    tb, (lora, base) = branch_a
    (jtok, jm, _, jctx) = jax_builder.load_pretrained_model(lora, base, load_8bit=load_8bit)
    (ttok, tm, _, tctx) = torch_builder.load_pretrained_model(lora, base, load_8bit=load_8bit,
                                                              device="cpu")
    assert tctx == jctx and len(ttok) == len(jtok)
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    tb.assert_trees_equal(tm.params, jm.params)
    if not load_8bit:  # the merge moved the base's kernels
        base_down = tb.tiny_state_dict()["model.layers.1.mlp.down_proj.weight"].T
        assert not torch.equal(tm.params["llm"]["layers"]["mlp"]["down"]["kernel"][1],
                               base_down.to(torch.bfloat16))
    frames = tb._frames()
    got, want = tb._prefill_logits(jm, tm, tb.PROMPT_IDS, frames)
    np.testing.assert_allclose(got, want, rtol=0, atol=tb.PREFILL_LOGITS_RTOL * np.abs(want).max())
    ours = tm.generate([tb.PROMPT_IDS], frames, tb.GREEDY)[0]
    theirs = jm.generate([tb.PROMPT_IDS], frames, tb.GREEDY)[0]
    diff = [i for i, (a, b) in enumerate(zip(ours, theirs)) if a != b]
    if diff:
        i = diff[0]
        for logits in tb._prefill_logits(jm, tm, tb.PROMPT_IDS + ours[:i], frames):
            top = np.sort(logits)[-2:]
            assert {ours[i], theirs[i]} == set(np.argsort(logits)[-2:].tolist())
            assert top[1] - top[0] <= BF16_TIE * abs(top[1])


# ------------------------------------------------------------------ server


_OrigChat = chat_mod.Chat


def test_lora_paths_through_the_server(models, setup, tmp_path, monkeypatch):
    """`--lora_paths` loads the dirs with load_multi_lora over the loaded
    model: in engine mode a request's JSON 'adapter' routes it (its answer
    is its single-adapter model's), a session turn over the stacked params
    raises (it passes no route) and is answered with its error."""
    cfg, p, _, _, _, _, _ = setup
    _, tm, singles = models
    sds = [_fake_peft_sd(cfg, RANK, 50 + i) for i in range(2)]
    dirs = [_write_peft_dir(tmp_path / f"ad{i}", sd, RANK) for i, sd in enumerate(sds)]
    base = singles[-1]
    processor = ImageProcessor(size=28)
    made = {}
    monkeypatch.setattr("teochat_torch.utils.resolve_device", lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(chat_mod, "Chat", lambda *a, **k: _OrigChat(
        model_bundle=(base.tokenizer, base, processor)))
    monkeypatch.setattr(ChatServer, "serve_forever", lambda self: made.setdefault("srv", self))
    server_mod.main(["--model_path", "unused", "--port", "0", "--host", "127.0.0.1",
                     "--continuous_batching", "--max_slots", "2", "--max_len", "128",
                     "--lora_paths", ",".join(dirs)])
    srv = made["srv"]
    monkeypatch.undo()
    try:
        srv.start_background()
        port = srv._httpd.server_address[1]
        assert torch_lora.num_stacked_adapters(srv.chat.model.params["llm"]) == 2
        payload = {"prompt": "Describe.", "images": [], "temperature": 0.0,
                   "max_new_tokens": 5}
        input_ids, _, gen = srv._engine_request(payload)
        for a in (1, -1):
            code, out = _post(port, {**payload, "adapter": a})
            model = base if a < 0 else torch_teochat.TEOChat(
                cfg, {**base.params, "llm": torch_convert.attach_lora_to_llama(
                    base.params["llm"], sds[a], cfg.llm, rank=RANK)}, tokenizer=base.tokenizer)
            want = model.generate([input_ids], None, gen)[0]
            assert code == 200 and out["response"] == srv._response_text(want), a
        code, out = _post(port, {**payload, "session_id": "s"})
        assert code == 400 and "adapter_route" in out["error"]
    finally:
        srv.engine.shutdown()
        srv.shutdown()


def _post(port, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", method="POST",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
