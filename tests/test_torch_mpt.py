"""The port's MPT backend (LLaVA-MPT serving) against the JAX package.

The same inputs, drawn from seeded numpy and carried across by
`bridge.to_torch`, go through JAX's models/mpt.py and the port's: the ALiBi
tables exactly; the flash kernel's plain twin and its tile walk with a
`bias_k` sliced from MPT-7B's table for a 4,096-slot cache (biases down to
~-3,400, whose fp32 ulp, ~2.4e-4, limits the scores) against
JAX's kernel in Pallas interpret mode; the decoder cache-free and along
every cached path (prefill, decode, spec_verify, attend_cache pieces,
row offsets) in fp32 to 1e-4 of the largest logit, cache slots too; the
int8 quantizers byte for byte; greedy generation, speculation, the builder,
a session and the engine token for token on a tiny LLaVA-MPT whose top
logits stand well apart (its tied wte is scaled up, so reduction order
cannot flip an argmax); a random HF `MptForCausalLM` through
`convert_hf_mpt`; the tokenizer adapter and the config's JSON.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from teochat_tpu import builder as jax_builder
from teochat_tpu.config import GenerationConfig, MptConfig, TEOChatConfig, tiny_test_config
from teochat_tpu.constants import IMAGE_TOKEN_INDEX as IMG
from teochat_tpu.models import llama as jax_llama
from teochat_tpu.models import mpt as jax_mpt
from teochat_tpu.models import teochat as jax_teochat
from teochat_tpu.ops import flash_attention as jax_flash
from teochat_tpu.ops import quant as jax_quant
from teochat_tpu.serve.session import ChatSession as JaxChatSession
from teochat_torch import builder as torch_builder
from teochat_torch.checkpoint.bridge import to_numpy, to_torch
from teochat_torch.config import MptConfig as TorchMptConfig
from teochat_torch.config import TEOChatConfig as TorchTEOChatConfig
from teochat_torch.models import llama as torch_llama
from teochat_torch.models import mpt as torch_mpt
from teochat_torch.models import teochat as torch_teochat
from teochat_torch.ops import attention as torch_attention
from teochat_torch.ops import flash_attention as flash_mod
from teochat_torch.ops import quant as torch_quant
from teochat_torch.serve.engine import BatchEngine
from teochat_torch.serve.session import ChatSession

# fp32 decoders on both sides: the same products in another order
RTOL, ATOL = 1e-4, 1e-5
# the flash twins with a cache-sized ALiBi table: JAX's kernel and the plain
# twin add biases of up to |3,443| to the scores, where half an fp32 ulp is
# 1.2e-4; the walk, as the CUDA kernel, first takes each head's table
# relative to its last key's bias, where the scores round ~10x finer. So p
# differs by up to ~1.2e-4 relative between them (read: o 2.2e-4, l 1.3e-4
# relative, m 2.4e-4, one ulp of m ~ -3,000); held to 5e-4
BIAS_RTOL, BIAS_ATOL = 5e-4, 5e-4
T_CACHE = 4096
KW = dict(vocab_size=96, d_model=64, n_layers=2, n_heads=4, expansion_ratio=2, max_seq_len=128)
WTE_GAIN = 20.0  # the tied head's rows scaled up: argmaxes far apart


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _mpt_params(cfg, seed, biases=False):
    """JAX's init_mpt with the wte scaled up (and random biases where the
    config has them), as a numpy tree."""
    params = _np_tree(jax_mpt.init_mpt(jax.random.PRNGKey(seed), cfg))
    params["wte"]["embedding"] = params["wte"]["embedding"] * WTE_GAIN
    if biases:
        rs = np.random.RandomState(seed + 100)
        for group in params["layers"].values():
            if "bias" in group:
                group["bias"] = (rs.randn(*group["bias"].shape) * 0.1).astype(np.float32)
        params["final_norm"]["bias"] = (rs.randn(cfg.d_model) * 0.1).astype(np.float32)
    return params


def _cfgs(**over):
    kw = {**KW, **over}
    return MptConfig(**kw), TorchMptConfig(**kw)


@pytest.fixture(scope="module")
def decoder():
    jcfg, tcfg = _cfgs()
    params = _mpt_params(jcfg, 0)
    return jcfg, tcfg, params, to_torch(params, "cpu")


def _close(got, want, rtol=RTOL):
    """`got` within `rtol` of the largest |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max() / scale


# ------------------------------------------------------------------- ALiBi


@pytest.mark.parametrize("n_heads,bias_max", [(4, 8), (6, 8), (32, 8), (7, 16)])
def test_alibi_tables_equal_jax(n_heads, bias_max):
    np.testing.assert_array_equal(torch_mpt.alibi_slopes(n_heads, bias_max).numpy(),
                                  np.asarray(jax_mpt.alibi_slopes(n_heads, bias_max)))
    np.testing.assert_array_equal(torch_mpt.alibi_bias(n_heads, 300, bias_max).numpy(),
                                  np.asarray(jax_mpt.alibi_bias(n_heads, 300, bias_max)))


# ------------------------------------------------------- the flash twins


def _table(h, s):
    """The first S columns of MPT-7B's first H heads' table for a 4,096-slot
    cache (32 heads, alibi_bias_max 8: the first slope 2^-0.25, biases down
    to -3,443): a row-strided view, as mpt_forward slices it."""
    return torch_mpt.alibi_bias(32, T_CACHE)[0, :h, 0, :s]


def _jax_forward_bias(q, k, v, bias):
    """(o, m, l) of JAX's K1 and K4a with bias_k in interpret mode, S padded
    to their 128-row tile (the bias with zeros: padded keys sit after every
    real query) and sliced back, as JAX's padded wrapper does."""
    s = q.shape[1]
    block = 128 if s > 128 else s
    pad = -s % block
    qp, kp, vp = (jnp.asarray(np.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0)))) for x in (q, k, v))
    bp = jnp.asarray(np.pad(bias, ((0, 0), (0, pad))))
    o1 = jax_flash.flash_attention(qp, kp, vp, bias_k=bp, causal=True, block_q=block,
                                   block_k=block, interpret=True)
    o2, m, l = jax_flash._flash_fwd_with_residuals(
        qp.transpose(0, 2, 1, 3), kp.transpose(0, 2, 1, 3), vp.transpose(0, 2, 1, 3), bp,
        causal=True, scale=q.shape[-1] ** -0.5, block_q=block, block_k=block, interpret=True)
    return (np.asarray(o1)[:, :s], np.asarray(o2.transpose(0, 2, 1, 3))[:, :s],
            np.asarray(m)[:, :, :s, 0], np.asarray(l)[:, :, :s, 0])


@pytest.mark.parametrize("b,s,h,hkv,d", [(1, 256, 4, 4, 64), (2, 200, 4, 1, 64),
                                         (1, 9, 2, 2, 128)], ids=["mha", "multiquery-ragged",
                                                                   "short"])
def test_flash_twins_with_bias_k_match_jax(b, s, h, hkv, d):
    q, k, v = _rand((b, s, h, d), s), _rand((b, s, hkv, d), s + 1), _rand((b, s, hkv, d), s + 2)
    bias = _table(h, s)
    assert bias.stride(0) == T_CACHE and float(bias.min()) < -100
    o_k1, o_k4a, want_m, want_l = _jax_forward_bias(q, k, v, bias.numpy())
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    plain = flash_mod.flash_attention(tq, tk, tv, bias_k=bias)  # the CPU runs the plain twin
    np.testing.assert_allclose(plain.numpy(), o_k1, rtol=BIAS_RTOL, atol=BIAS_ATOL)
    o, m, l = flash_mod.flash_forward_schedule(tq, tk, tv, bias_k=bias)
    np.testing.assert_allclose(o.numpy(), o_k1, rtol=BIAS_RTOL, atol=BIAS_ATOL)
    np.testing.assert_allclose(o.numpy(), o_k4a, rtol=BIAS_RTOL, atol=BIAS_ATOL)
    np.testing.assert_allclose(m.numpy(), want_m, rtol=BIAS_RTOL, atol=BIAS_ATOL)
    np.testing.assert_allclose(l.numpy(), want_l, rtol=BIAS_RTOL, atol=0)
    pm, pl = flash_mod.flash_statistics_plain(tq, tk, tv, bias_k=bias)
    np.testing.assert_allclose(pm.numpy(), want_m, rtol=BIAS_RTOL, atol=BIAS_ATOL)
    np.testing.assert_allclose(pl.numpy(), want_l, rtol=BIAS_RTOL, atol=0)


def test_bias_k_is_an_explicit_bias_and_the_trainable_path_takes_it():
    """dot_product_attention(bias_k=) is the plain attention with the
    [1, H, 1, T] bias; the trainable flash path on the CPU is autograd
    through it, the table a constant; both bias forms at once raise, as do
    a table of the wrong shape and the CUDA backward with a bias."""
    q, k, v = (torch.from_numpy(_rand(shape, i)) for i, shape in
               enumerate([(2, 33, 4, 16), (2, 33, 2, 16), (2, 33, 2, 16)]))
    bias = _table(4, 33)
    want = torch_attention.plain_attention(q, k, v, bias=bias[None, :, None, :], causal=True)
    assert torch.equal(torch_attention.dot_product_attention(q, k, v, bias_k=bias, causal=True),
                       want)
    assert torch.equal(flash_mod.flash_attention(q, k, v, bias_k=bias), want)
    qg = q.clone().requires_grad_()
    out = flash_mod.flash_attention_trainable_padded(qg, k, v, True, bias_k=bias)
    assert torch.equal(out.detach(), want)
    out.sum().backward()
    assert torch.isfinite(qg.grad).all() and qg.grad.abs().sum() > 0
    with pytest.raises(ValueError, match="either bias or bias_k"):
        torch_attention.dot_product_attention(q, k, v, bias=bias[None, :, None, :],
                                              bias_k=bias)
    with pytest.raises(ValueError, match="bias_k shape"):
        flash_mod.flash_attention(q, k, v, bias_k=bias[:, :30])
    ctx = type("Ctx", (), {"has_bias": True})()
    with pytest.raises(NotImplementedError, match="ROADMAP item 14"):
        flash_mod._FlashTrainable.backward(ctx, torch.zeros(1))


# ------------------------------------------------------------ the decoder


@pytest.mark.parametrize("case", ["mha", "multiquery", "biases", "padding mask"])
def test_mpt_forward_cache_free_matches_jax(case):
    over = {"multiquery": dict(attn_type="multiquery_attention"),
            "biases": dict(no_bias=False, logit_scale=0.5)}.get(case, {})
    jcfg, tcfg = _cfgs(**over)
    params = _mpt_params(jcfg, 1, biases=case == "biases")
    emb = _rand((2, 11, jcfg.d_model), 2)
    mask = None
    if case == "padding mask":
        mask = np.arange(11)[None] < np.array([[11], [7]])
    want, _ = jax_mpt.mpt_forward(params, jcfg, jnp.asarray(emb),
                                  attention_mask=None if mask is None else jnp.asarray(mask))
    got = torch_mpt.mpt_forward(to_torch(params, "cpu"), tcfg, torch.from_numpy(emb),
                                attention_mask=None if mask is None else torch.from_numpy(mask))
    _close(got.numpy(), want)


def _prompt(b_lens, s, t_max):
    """Right-padded prompt positions, slots (pads at the trash slot) and the
    prefix kv_mask of a batch of lengths `b_lens` padded to S."""
    lens = np.asarray(b_lens)
    mask = np.arange(s)[None] < lens[:, None]
    slots = np.where(mask, np.arange(s)[None], t_max - 1).astype(np.int32)
    kv_mask = np.arange(t_max)[None] < lens[:, None]
    return lens, slots, kv_mask


class _Pair:
    """A JAX cache and the port's, driven with the same calls."""

    def __init__(self, decoder, rows, t_max):
        self.jcfg, self.tcfg, self.params, self.tparams = decoder
        self.jcache = jax_llama.init_cache(self.jcfg, rows, t_max, dtype=jnp.float32)
        self.tcache = torch_llama.init_cache(self.tcfg, rows, t_max, dtype=torch.float32,
                                             device="cpu")

    def run(self, emb, **kw):
        jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
        tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()}
        want, self.jcache = jax_mpt.mpt_forward(self.params, self.jcfg, jnp.asarray(emb),
                                                cache=self.jcache, **jkw)
        got = torch_mpt.mpt_forward(self.tparams, self.tcfg, torch.from_numpy(emb),
                                    cache=self.tcache, **tkw)
        _close(got.numpy(), want)
        return got

    def check_cache(self, rows=slice(None), slots=slice(None)):
        for t, j in ((self.tcache.k, self.jcache.k), (self.tcache.v, self.jcache.v)):
            _close(t.numpy()[:, rows, slots], np.asarray(j)[:, rows, slots])


def test_cached_prefill_decode_and_verify_match_jax(decoder):
    """A ragged right-padded prefill (pads at the trash slot), two decode
    steps (one with kv_mask, one with the port's kv_len), then a 3-token
    spec_verify block: logits and the cache's live slots as JAX's."""
    t_max, s = 40, 12
    pair = _Pair(decoder, 2, t_max)
    lens, slots, kv_mask = _prompt([12, 7], s, t_max)
    emb = _rand((2, s, KW["d_model"]), 5)
    pair.run(emb, write_slots=slots, kv_mask=kv_mask, logits_mode="last",
             last_index=(lens - 1).astype(np.int32))
    pair.check_cache(slots=slice(0, 7))
    pos = lens.astype(np.int32)
    pair.run(emb[:, :1], write_slots=pos[:, None], logits_mode="last",
             kv_mask=np.arange(t_max)[None] <= pos[:, None])
    pos = pos + 1
    # the port's kv_len [B] against JAX's prefix mask
    want, pair.jcache = jax_mpt.mpt_forward(
        pair.params, pair.jcfg, jnp.asarray(emb[:, 1:2]), cache=pair.jcache,
        write_slots=jnp.asarray(pos[:, None]), logits_mode="last",
        kv_mask=jnp.asarray(np.arange(t_max)[None] <= pos[:, None]))
    got = torch_mpt.mpt_forward(pair.tparams, pair.tcfg, torch.from_numpy(emb[:, 1:2]),
                                cache=pair.tcache, write_slots=torch.from_numpy(pos[:, None]),
                                kv_len=torch.from_numpy(pos + 1), logits_mode="last")
    _close(got.numpy(), want)
    pos = pos + 1
    blk = (pos[:, None] + np.arange(3)[None]).astype(np.int32)
    kv_mask = np.arange(t_max)[None] <= blk[:, -1:]
    pair.run(emb[:, 3:6], write_slots=blk, kv_mask=kv_mask, logits_mode="all", spec_verify=True)
    pair.check_cache(rows=0, slots=slice(0, int(pos[0]) + 3))
    pair.check_cache(rows=1, slots=slice(0, int(pos[1]) + 3))


def test_chunked_and_row_offset_prefills_match_jax(decoder):
    """The engine's pieces: a prefill at row 2 of a 3-row cache, then a
    prompt committed in two attend_cache pieces (prefill_start 0 and 8,
    each query over the row's cache up to its slot) at row 1, logits_mode
    'none' for the first; logits and the rows' slots as JAX's, and the
    last piece's logits as the monolithic prefill's."""
    t_max, s = 32, 16
    pair = _Pair(decoder, 3, t_max)
    emb = _rand((1, s, KW["d_model"]), 6)
    full = np.arange(s, dtype=np.int32)[None]
    whole = pair.run(emb, write_slots=full, logits_mode="last",
                     last_index=np.array([s - 1], np.int32), cache_row_offset=2)
    first = np.arange(8, dtype=np.int32)[None]
    pair.run(emb[:, :8], write_slots=first, logits_mode="none", cache_row_offset=1,
             prefill_start=0, attend_cache=True)
    tail = pair.run(emb[:, 8:], write_slots=first + 8, logits_mode="last",
                    last_index=np.array([7], np.int32), cache_row_offset=1, prefill_start=8,
                    attend_cache=True)
    _close(tail.numpy(), whole.numpy())
    pair.check_cache(rows=slice(1, 3), slots=slice(0, s))
    assert not pair.tcache.k[:, 0].any()


def test_quantizers_match_jax_and_int8_logits(decoder):
    """quantize_mpt_params and the host form byte for byte against JAX's
    (biases carried beside the int8 kernels), and the int8 decoder's logits
    against JAX's int8 decoder."""
    jcfg, tcfg = _cfgs(no_bias=False)
    params = _mpt_params(jcfg, 2, biases=True)
    want = _np_tree(jax_quant.quantize_mpt_params(params))
    got = torch_quant.quantize_mpt_params(to_torch(params, "cpu"))
    host = torch_quant.quantize_mpt_params_host(
        {k: v for k, v in to_torch(params, "cpu").items()}, layer_chunk=1, device="cpu")
    want_host = _np_tree(jax_quant.quantize_mpt_params_host(params, layer_chunk=1))
    for tree, ref in ((got, want), (host, want_host)):
        flat, ref_flat = jax.tree.leaves_with_path(to_numpy(tree)), jax.tree.leaves_with_path(ref)
        assert [p for p, _ in flat] == [p for p, _ in ref_flat]
        for (path, a), (_, b) in zip(flat, ref_flat):
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(a, b, err_msg=str(path))
    assert "bias" in got["layers"]["wqkv"] and got["layers"]["wqkv"]["kernel"].dtype == torch.int8
    emb = _rand((2, 9, jcfg.d_model), 3)
    ref, _ = jax_mpt.mpt_forward(jax_quant.quantize_mpt_params(params), jcfg, jnp.asarray(emb))
    _close(torch_mpt.mpt_forward(got, tcfg, torch.from_numpy(emb)).numpy(), ref)


# ------------------------------------------------------------ LLaVA-MPT


def _llava_mpt_cfg(**over):
    base = dataclasses.replace(tiny_test_config(vocab_size=KW["vocab_size"]), dtype="float32")
    return dataclasses.replace(base, llm=MptConfig(**{**KW, **over}), llm_backend="mpt")


def _greedy(max_new, **over):
    return GenerationConfig(max_new_tokens=max_new, temperature=0.0, do_sample=False,
                            stop_strings=(), **over)


@pytest.fixture(scope="module")
def models():
    """(JAX TEOChat, the port's TEOChat) on the same fp32 LLaVA-MPT weights."""
    cfg = _llava_mpt_cfg()
    params = _np_tree(jax_teochat.init_teochat(jax.random.PRNGKey(7), cfg))
    params["llm"]["wte"]["embedding"] = params["llm"]["wte"]["embedding"] * WTE_GAIN
    return (jax_teochat.TEOChat(cfg, params),
            torch_teochat.TEOChat(cfg, to_torch(params, "cpu")))


def test_generate_and_speculation_match_jax(models):
    """Greedy TEOChat.generate over a ragged batch with frames: JAX's tokens;
    prompt-lookup speculation (k 3) gives them too, and accepts drafts on a
    self-repeating prompt."""
    jm, tm = models
    rs = np.random.RandomState(8)
    ids = [[1, 5, IMG, 7, 8, IMG, 9], [1, 3, 4], [1, IMG, 6]]
    frames = rs.randn(3, 3, 28, 28).astype(np.float32)
    want = jm.generate(ids, frames, _greedy(8))
    assert tm.generate(ids, frames, _greedy(8)) == want
    assert tm.generate(ids, frames, _greedy(8, speculative_k=3)) == want
    assert tm.last_spec_stats["steps"] >= 1
    echo = [[1, 5, 6, 7, 8] * 6]
    plain = tm.generate(echo, None, _greedy(12))
    assert plain == jm.generate(echo, None, _greedy(12))
    assert tm.generate(echo, None, _greedy(12, speculative_k=4)) == plain


def test_session_matches_jax_over_three_turns(models):
    """An MPT ChatSession (prefill_full, then suffix prefills over the
    committed turns, on the masked cache read) against JAX's: the same
    tokens and stats each turn, plain and with speculative_k 3."""
    jm, tm = models
    rs = np.random.RandomState(0)
    frames = rs.randn(2, 3, 28, 28).astype(np.float32)
    for gen in (_greedy(5), _greedy(5, speculative_k=3)):
        jsession, session = JaxChatSession(jm, max_len=256), ChatSession(tm, max_len=256)
        convo, pixels = [1, 5, 9, 4, 7], None
        for turn in range(3):
            want = jsession.generate(convo, pixels, gen)
            assert session.generate(convo, pixels, gen) == want, (gen.speculative_k, turn)
            assert session.stats == jsession.stats
            convo = convo + want + ([13, IMG, 8, IMG, 6] if turn == 0 else [11, 12])
            pixels = frames
        assert session.stats["reused_tokens"] > 0


def test_chat_and_server_serve_mpt(models):
    """JAX's test_chat_serves_mpt_with_kv_sessions on the port: the port's
    Chat over MPT with sessions, without them and with speculative_k 3 gives
    the JAX Chat's responses over two turns; then one session turn through
    ChatServer on an ephemeral port gives the same first response."""
    import urllib.request

    from teochat_tpu.data.processing import ImageProcessor as JaxImageProcessor
    from teochat_tpu.serve.chat import Chat as JaxChat
    from teochat_torch.data.processing import ImageProcessor
    from teochat_torch.serve.chat import Chat
    from teochat_torch.serve.server import ChatServer
    from tests.test_eval_e2e import MockTokenizer

    jm, tm = models
    tok = MockTokenizer()
    jmodel = jax_teochat.TEOChat(jm.cfg, jm.params, tokenizer=tok)
    tmodel = torch_teochat.TEOChat(tm.cfg, tm.params, tokenizer=tok)
    want_chat = JaxChat(model_bundle=(tok, jmodel, JaxImageProcessor(size=28)), incremental=False)

    def chat(**kw):
        return Chat(model_bundle=(tok, tmodel, ImageProcessor(size=28)), **kw)

    chats = [(chat(), 0), (chat(incremental=False), 0), (chat(), 3)]
    imgs = [np.random.RandomState(i).randint(0, 255, (40, 40, 3), np.uint8) for i in range(2)]
    first = None
    for text, frames in (("What is here?", imgs), ("And now?", [])):
        kw = dict(temperature=0.0, max_new_tokens=4)
        want = want_chat.generate(text, frames, **kw)
        first = first or want
        for c, k in chats:
            assert c.generate(text, frames, speculative_k=k, **kw) == want, k
    assert chats[0][0]._session.stats["reused_tokens"] > 0
    srv = ChatServer(chat(), host="127.0.0.1", port=0)
    srv.start_background()
    try:
        import base64
        import io

        from PIL import Image

        def b64(a):
            buf = io.BytesIO()
            Image.fromarray(a).save(buf, format="PNG")
            return base64.b64encode(buf.getvalue()).decode()

        body = json.dumps({"prompt": "What is here?", "images": [b64(a) for a in imgs],
                           "temperature": 0.0, "max_new_tokens": 4,
                           "session_id": "s"}).encode()
        url = f"http://127.0.0.1:{srv._httpd.server_address[1]}/generate"
        req = urllib.request.Request(url, data=body, method="POST",
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert json.loads(r.read()) == first
    finally:
        srv.shutdown()


def test_engine_serves_mpt(models):
    """The continuous-batching engine on MPT (monolithic and chunked
    prefill, and speculative): each request's greedy tokens are JAX's
    TEOChat.generate's."""
    jm, tm = models
    rs = np.random.RandomState(4)
    prompts = [([1, IMG] + list(rs.randint(4, 90, 12 + 6 * i)),
                rs.randn(1, 3, 28, 28).astype(np.float32)) for i in range(2)]
    gen = _greedy(5)
    expected = [jm.generate([ids], fr, gen)[0] for ids, fr in prompts]
    for kw in (dict(), dict(prefill_chunk=8), dict(speculative_k=3)):
        engine = BatchEngine(tm, max_slots=2, max_len=96, chunk=2, **kw).start()
        try:
            assert [engine.submit(ids, fr, gen) for ids, fr in prompts] == expected, kw
        finally:
            engine.shutdown()


def test_config_json_round_trip_and_cross_package():
    cfg = _llava_mpt_cfg(attn_type="multiquery_attention", logit_scale=0.5)
    back = TorchTEOChatConfig.from_json(cfg.to_json())
    assert isinstance(back.llm, TorchMptConfig) and back.llm_backend == "mpt"
    assert dataclasses.asdict(back) == dataclasses.asdict(cfg)
    assert TorchTEOChatConfig.from_json(back.to_json()) == back
    assert dataclasses.asdict(TEOChatConfig.from_json(back.to_json())) == dataclasses.asdict(cfg)


def test_adapt_tokenizer_for_denoising_matches_jax(tmp_path):
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(WordLevel({"<unk>": 0, "hello": 1, "world": 2}, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    tok.save(str(tmp_path / "tokenizer.json"))

    def adapted(fn):
        t = PreTrainedTokenizerFast(tokenizer_file=str(tmp_path / "tokenizer.json"),
                                    unk_token="<unk>")
        fn(t)
        n = len(t)
        fn(t)  # idempotent
        assert len(t) == n
        return t

    got = adapted(torch_mpt.adapt_tokenizer_for_denoising)
    want = adapted(jax_mpt.adapt_tokenizer_for_denoising)
    assert got.get_vocab() == want.get_vocab()
    assert got.sentinel_token_ids == want.sentinel_token_ids
    assert len(set(got.sentinel_token_ids)) == torch_mpt.NUM_SENTINEL_TOKENS
    assert got.pad_token == want.pad_token == "<pad>"


def test_hf_mpt_parity():
    """A random tiny HF MptForCausalLM (ALiBi, eager attention) through
    convert_hf_mpt: the port's logits are HF's, and its cached greedy decode
    gives HF generate's tokens."""
    from transformers import MptConfig as HFMptConfig
    from transformers import MptForCausalLM

    torch.manual_seed(0)
    _, tcfg = _cfgs(expansion_ratio=4)
    hf = MptForCausalLM(HFMptConfig(
        vocab_size=tcfg.vocab_size, d_model=tcfg.d_model, n_layers=tcfg.n_layers,
        n_heads=tcfg.n_heads, expansion_ratio=4, max_seq_len=tcfg.max_seq_len,
        attn_config={"attn_impl": "eager", "alibi": True, "alibi_bias_max": 8})).eval()
    params = torch_mpt.convert_hf_mpt(hf.state_dict(), tcfg)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, tcfg.vocab_size, (2, 7)))
    with torch.no_grad():
        ref = hf(ids).logits
        got = torch_mpt.mpt_forward(params, tcfg, torch_mpt.mpt_embed(params, ids))
        torch.testing.assert_close(got, ref, atol=3e-4, rtol=1e-3)
        prompt, n_new = ids[:1, :5], 6
        want = hf.generate(prompt, max_new_tokens=n_new, do_sample=False, eos_token_id=None,
                           pad_token_id=0)[0, 5:].tolist()
        cache = torch_llama.init_cache(tcfg, 1, 5 + n_new, dtype=torch.float32, device="cpu")
        logits = torch_mpt.mpt_forward(params, tcfg, torch_mpt.mpt_embed(params, prompt),
                                       cache=cache, write_slots=torch.arange(5)[None],
                                       logits_mode="last")
        toks = [int(logits[0, -1].argmax())]
        for step in range(n_new - 1):
            emb = torch_mpt.mpt_embed(params, torch.tensor([[toks[-1]]]))
            logits = torch_mpt.mpt_forward(params, tcfg, emb, cache=cache,
                                           write_slots=torch.tensor([[5 + step]]),
                                           logits_mode="last")
            toks.append(int(logits[0, -1].argmax()))
    assert toks == want


# ------------------------------------------------------------- the builder

HOT = [5, 17, 33, 60, 81]


def _write_llava_mpt(path, patch_token):
    """A tiny LLaVA-MPT checkpoint dir (fp16 `transformer.*` decoder,
    projector and tower, config.json, a word-level tokenizer); the tied
    wte's HOT rows are 6 times the others, so a hot token's logit stands
    clear of the next."""
    from tests.test_torch_builder import TOWER, write_tokenizer

    os.makedirs(path)
    g = torch.Generator().manual_seed(0)
    d, vocab, layers, ffn = KW["d_model"], KW["vocab_size"], KW["n_layers"], 2 * KW["d_model"]

    def w(*shape, std=0.05):
        return (torch.randn(*shape, generator=g) * std).half()

    wte = torch.randn(vocab, d, generator=g) * 0.5
    wte[HOT] *= 6.0
    sd = {"transformer.wte.weight": wte.half(), "transformer.norm_f.weight": w(d, std=0.1) + 1}
    for i in range(layers):
        p = f"transformer.blocks.{i}."
        sd[p + "norm_1.weight"], sd[p + "norm_2.weight"] = w(d, std=0.1) + 1, w(d, std=0.1) + 1
        sd[p + "attn.Wqkv.weight"] = w(3 * d, d)
        sd[p + "attn.out_proj.weight"] = w(d, d)
        sd[p + "ffn.up_proj.weight"] = w(ffn, d)
        sd[p + "ffn.down_proj.weight"] = w(d, ffn)
    m = TOWER["hidden_size"]
    sd.update({"transformer.mm_projector.0.weight": w(d, m, std=0.2),
               "transformer.mm_projector.0.bias": w(d),
               "transformer.mm_projector.2.weight": w(d, d, std=0.2),
               "transformer.mm_projector.2.bias": w(d)})
    vt = "transformer.image_tower.vision_model."
    sd[vt + "embeddings.patch_embedding.weight"] = w(m, 3, 14, 14)
    sd[vt + "embeddings.class_embedding"] = w(m)
    sd[vt + "embeddings.position_embedding.weight"] = w(5, m)
    for ln in ("pre_layrnorm", "post_layernorm"):
        sd[vt + ln + ".weight"], sd[vt + ln + ".bias"] = w(m) + 1, w(m)
    for i in range(TOWER["num_layers"]):
        e = vt + f"encoder.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[e + f"self_attn.{n}.weight"], sd[e + f"self_attn.{n}.bias"] = w(m, m, std=0.2), w(m)
        for ln in ("layer_norm1", "layer_norm2"):
            sd[e + ln + ".weight"], sd[e + ln + ".bias"] = w(m) + 1, w(m)
        sd[e + "mlp.fc1.weight"], sd[e + "mlp.fc1.bias"] = w(2 * m, m, std=0.2), w(2 * m)
        sd[e + "mlp.fc2.weight"], sd[e + "mlp.fc2.bias"] = w(m, 2 * m, std=0.2), w(m)
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "llava_mpt", "vocab_size": vocab, "d_model": d,
                   "n_layers": layers, "n_heads": KW["n_heads"], "expansion_ratio": 2,
                   "max_seq_len": 128, "attn_config": {"alibi": True, "alibi_bias_max": 8},
                   "mm_projector_type": "mlp2x_gelu", "mm_hidden_size": m,
                   "mm_use_im_patch_token": patch_token, "tokenizer_model_max_length": 128,
                   "max_sequence_length": 128}, f)
    write_tokenizer(path, vocab)
    return str(path)


@pytest.mark.parametrize("case", ["bf16", "load_8bit", "patch token"])
def test_builder_loads_llava_mpt_as_jax_does(tmp_path, case):
    """Both packages' load_pretrained_model on one tiny LLaVA-MPT dir (an
    "mpt" name): the same trees (int8 kernels and scales byte for byte
    under load_8bit; a vision token added and the tied wte grown by its
    mean row), last-position prefill logits within 1 % of the largest
    (bf16 weights on both sides) and the same greedy tokens; load_int4
    raises in both."""
    from tests.test_torch_builder import _tiny_tower_config, assert_trees_equal

    path = _write_llava_mpt(tmp_path / "llava-mpt-tiny", patch_token=case == "patch token")
    kw = {"load_8bit": True} if case == "load_8bit" else {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_builder, "load_config", _tiny_tower_config(jax_builder.load_config))
        mp.setattr(torch_builder, "load_config", _tiny_tower_config(torch_builder.load_config))
        _, jm, _, _ = jax_builder.load_pretrained_model(path, None, "llava-mpt-tiny", **kw)
        ttok, tm, _, ctx = torch_builder.load_pretrained_model(path, None, "llava-mpt-tiny",
                                                               device="cpu", **kw)
        for load, dev in ((jax_builder.load_pretrained_model, {}),
                          (torch_builder.load_pretrained_model, {"device": "cpu"})):
            with pytest.raises(NotImplementedError, match="llama backend"):
                load(path, None, "llava-mpt-tiny", load_int4=True, **dev)
    assert isinstance(tm.cfg.llm, TorchMptConfig) and tm.cfg.llm_backend == "mpt" and ctx == 128
    assert tm.cfg.llm.vocab_size == len(ttok) == KW["vocab_size"] + (case == "patch token")
    assert_trees_equal(tm.params, jm.params)
    if case == "load_8bit":
        assert tm.params["llm"]["layers"]["wqkv"]["kernel"].dtype == torch.int8
    frames = np.random.RandomState(4).randn(2, 3, 28, 28).astype(np.float32)
    ids = [[1, 5, IMG, 9, 11, IMG, 40, 41]]
    plan = dict(tokens_per_frame=tm.tokens_per_frame, pad_to=32)
    from teochat_tpu.models import fusion as jax_fusion
    from teochat_torch.models import fusion as torch_fusion

    plan_j, plan_t = jax_fusion.build_fusion_plan(ids, **plan), torch_fusion.build_fusion_plan(ids, **plan)
    last = int(plan_t.seq_lens[0]) - 1
    emb_j = jax_teochat.multimodal_embeds(jm.params, jm.cfg, plan_j, jm.encode(frames))
    want, _ = jax_mpt.mpt_forward(jm.params["llm"], jm.cfg.llm, emb_j)
    with torch.no_grad():
        emb_t = torch_teochat.multimodal_embeds(tm.params, tm.cfg, plan_t, tm.encode(frames))
        got = torch_mpt.mpt_forward(tm.params["llm"], tm.cfg.llm, emb_t)
    want = np.asarray(want[0, last], np.float32)
    _close(got[0, last].float().numpy(), want, rtol=1e-2)
    top2 = np.sort(want)[-2:]
    assert top2[1] - top2[0] > 2e-2 * np.abs(want).max()
    assert tm.generate(ids, frames, _greedy(4)) == jm.generate(ids, frames, _greedy(4))
