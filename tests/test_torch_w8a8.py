"""The port's w8a8 path (per-token int8 activations x int8 weights) against
the JAX package on the CPU.

`quantized_proj_act_i8` is held bit for bit to `jax.jit` of the JAX function
on bf16 and fp32 inputs (the form the JAX package runs: its callers are
jitted, where XLA multiplies by fp32(1 / 127)), 2-D, 3-D, at 5 rows, with an
all-zero row. `quantize_vit_params` gives JAX's leaves exactly. On the tiny
fp32 model (seeded weights, the lm_head scaled up so argmaxes are clear),
the w8a8 tower, the w8a8 prefill (cache-free and cached), `prefill_suffix`
and `TEOChat.generate` with `int8_prefill_activations` follow JAX within
W8A8_RTOL of the largest |output|: both quantize the same fp32 activations,
which agree to ~1e-7, so a value on a rounding edge can move one int8 step
at most and the read differences are ~5e-7. The w8a8 logits leave the
w8a16 ones by ~1e-3 of the largest, far outside that tolerance, so each
comparison also shows the w8a8 path ran. A speculative verify block keeps
the plain decode's activations, and no decode step (the loops a CUDA graph
captures on the card) takes a w8a8 product.
"""

import dataclasses

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
from teochat_tpu.models import vit as jax_vit
from teochat_tpu.ops import quant as jax_quant
from teochat_torch.checkpoint.bridge import to_numpy, to_torch
from teochat_torch.models import generation as torch_gen
from teochat_torch.models import llama as torch_llama
from teochat_torch.models import teochat as torch_teochat
from teochat_torch.models import vit as torch_vit
from teochat_torch.ops import quant as torch_quant

W8A8_RTOL = 1e-5  # of the largest |output| (see above)
GREEDY = GenerationConfig(max_new_tokens=6, temperature=0.0, do_sample=False, stop_strings=())
_jax_proj = jax.jit(jax_quant.quantized_proj_act_i8)
_jax_forward = jax.jit(jax_llama.llama_forward, static_argnames=("cfg",))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol=W8A8_RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("shape,dtype", [((12, 64), "bfloat16"), ((2, 7, 64), "bfloat16"),
                                         ((5, 96), "bfloat16"), ((3, 9, 128), "float32")],
                         ids=["2d", "3d", "m5", "3d fp32"])
def test_w8a8_projection_is_jitted_jax_bit_for_bit(shape, dtype):
    rs = np.random.RandomState(0)
    k = shape[-1]
    w = (rs.randn(k, 40) * 0.05).astype(np.float32)
    w[:, 3] = 0.0  # a zero channel: scale 1
    # rows of very different magnitudes, one all zero (scale_x 1, output 0)
    x = rs.randn(*shape) * rs.choice([1e-3, 1.0, 40.0], size=shape[:-1] + (1,))
    x.reshape(-1, k)[1] = 0.0
    xj = jnp.asarray(x, getattr(jnp, dtype))
    p = jax_quant.quantize_kernel(jnp.asarray(w))
    want = np.asarray(_jax_proj(xj, p).astype(jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    got = torch_quant.quantized_proj_act_i8(xt, to_torch(_np(p), "cpu"))
    assert got.dtype == xt.dtype and got.shape == xt.shape[:-1] + (40,)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not want.reshape(-1, 40)[1].any()


def test_int8_matmul_is_exact_off_multiples_of_8():
    """K and N off a multiple of 8 are zero-padded for `torch._int_mm`; the
    int32 sums are exact whatever the padding (the card's row padding is
    tests/test_torch_cuda.py::test_w8a8_int_mm_pads_rows_exactly)."""
    g = torch.Generator().manual_seed(1)
    for m, k, n in ((3, 20, 10), (1, 8, 8), (33, 64, 200)):
        a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
        got = torch_quant.int8_matmul(a, b)
        assert got.dtype == torch.int32 and got.shape == (m, n)
        assert torch.equal(got, a.int() @ b.int())


@pytest.fixture(scope="module")
def video_tower():
    cfg = tiny_test_config(add_time_attn=True).vision
    params = jax_vit.init_vit(jax.random.PRNGKey(2), cfg)
    return cfg, params


def test_quantize_vit_params_gives_jax_leaves(video_tower):
    """attn, temporal_attn and mlp quantized, biases kept, the rest as it
    was: the same tree and bytes as JAX's (both the eager form)."""
    _, params = video_tower
    want = _np(jax_quant.quantize_vit_params(params))
    q = torch_quant.quantize_vit_params(to_torch(_np(params), "cpu"))
    for group in ("attn", "temporal_attn", "mlp"):  # stored for int8_matmul without a copy
        assert all(leaf["kernel"][0].stride(0) == 1 for leaf in q["layers"][group].values())
    got = to_numpy(q)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    for group in ("attn", "temporal_attn", "mlp"):
        for leaf in got["layers"][group].values():
            assert set(leaf) == {"kernel", "scale", "bias"} and leaf["kernel"].dtype == np.int8
    assert got["layers"]["ln1"]["scale"].dtype == np.float32  # a LayerNorm is not quantized


def test_init_encoder_draws_the_w8a8_tower():
    """`init_encoder(vision_quant="int8")` (the bench's w8a8 tower) is
    `quantize_vit_params` of the fp32 tower drawn from the same seed, leaf
    for leaf (temporal attention included)."""
    from teochat_torch.checkpoint import bridge
    from teochat_torch.config import tiny_test_config as torch_tiny

    cfg = dataclasses.replace(torch_tiny(add_time_attn=True), dtype="float32")
    plain, w8 = (bridge.init_encoder(cfg, torch.Generator().manual_seed(5), "cpu", torch.float32,
                                     vision_quant=q) for q in (None, "int8"))
    want = to_numpy(torch_quant.quantize_vit_params(plain["vision"]))
    assert all(leaf["kernel"][0].stride(0) == 1
               for group in ("attn", "temporal_attn", "mlp")
               for leaf in w8["vision"]["layers"][group].values())
    got = to_numpy(w8["vision"])
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("frames", [1, 4], ids=["image", "video"])
def test_w8a8_tower_matches_jax(video_tower, frames):
    """The w8a8 tower's hidden states: the image geometry alone and the
    video tower over 4 frames (temporal attention w8a8 too)."""
    cfg, params = video_tower
    if frames == 1:
        cfg = dataclasses.replace(cfg, add_time_attn=False)
        params = {**params, "layers": {k: v for k, v in params["layers"].items()
                                       if not k.startswith("temporal")}}
    q = jax_quant.quantize_vit_params(params)
    x = np.random.RandomState(3).randn(2 * frames, 3, 28, 28).astype(np.float32)
    fwd = jax.jit(lambda p, px: jax_vit.vit_forward(p, cfg, px, num_frames=frames))
    want, plain = np.asarray(fwd(q, jnp.asarray(x))), np.asarray(fwd(params, jnp.asarray(x)))
    with torch.no_grad():
        got = torch_vit.vit_forward(to_torch(_np(q), "cpu"), cfg, torch.from_numpy(x),
                                    num_frames=frames).numpy()
    _close(got, want)
    assert np.abs(plain - want).max() > 20 * W8A8_RTOL * np.abs(want).max()


@pytest.fixture(scope="module")
def int8_models():
    """The tiny fp32 TEOChat with int8 decoder projections (the lm_head x40),
    in both packages, with `int8_prefill_activations` on."""
    cfg = dataclasses.replace(tiny_test_config(vocab_size=128), dtype="float32")
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, int8_prefill_activations=True))
    params = jax_teochat.init_teochat(jax.random.PRNGKey(7), cfg)
    llm = dict(params["llm"])
    llm["lm_head"] = {"kernel": llm["lm_head"]["kernel"] * 40.0}
    params = {**params, "llm": jax_quant.quantize_llama_params(llm)}
    return (jax_teochat.TEOChat(cfg, params),
            torch_teochat.TEOChat(cfg, to_torch(_np(params), "cpu")))


def _embeds(b, s, d, seed):
    return np.random.RandomState(seed).randn(b, s, d).astype(np.float32) * 0.5


def test_w8a8_prefill_logits_match_jax(int8_models):
    """Cache-free and cached prefills of a ragged batch: all logits w8a8 and
    close to JAX's; the w8a16 logits (the flag off) are far from them."""
    jm, tm = int8_models
    cfg = jm.cfg.llm
    b, s = 2, 12
    emb = _embeds(b, s, cfg.hidden_size, 1)
    mask = np.ones((b, s), bool)
    mask[1, 9:] = False
    pos = np.tile(np.arange(s), (b, 1))
    want = np.asarray(_jax_forward(jm.params["llm"], cfg, jnp.asarray(emb),
                                   position_ids=jnp.asarray(pos),
                                   attention_mask=jnp.asarray(mask))[0])
    off = dataclasses.replace(cfg, int8_prefill_activations=False)
    plain = np.asarray(_jax_forward(jm.params["llm"], off, jnp.asarray(emb),
                                    position_ids=jnp.asarray(pos),
                                    attention_mask=jnp.asarray(mask))[0])
    with torch.no_grad():
        got = torch_llama.llama_forward(tm.params["llm"], cfg, torch.from_numpy(emb),
                                        position_ids=torch.from_numpy(pos),
                                        attention_mask=torch.from_numpy(mask)).numpy()
        cache = torch_llama.init_cache(cfg, b, 16, dtype=torch.float32, device="cpu")
        slots = torch.from_numpy(np.where(mask, pos, 15))
        cached = torch_llama.llama_forward(tm.params["llm"], cfg, torch.from_numpy(emb),
                                           position_ids=torch.from_numpy(pos), cache=cache,
                                           write_slots=slots).numpy()
    _close(got, want)
    _close(cached[0], want[0])
    _close(cached[1, :9], want[1, :9])
    assert np.abs(plain - want).max() > 20 * W8A8_RTOL * np.abs(want).max()


def test_prefill_suffix_keeps_w8a8_and_matches_jax(int8_models):
    """A session's suffix prefill over a committed prefix takes w8a8 (JAX's
    act_quant_ok=True) while its cache mode is spec_verify's."""
    jm, tm = int8_models
    cfg = jm.cfg.llm
    d, t_max = cfg.hidden_size, 32
    emb1, emb2 = _embeds(1, 8, d, 2), _embeds(1, 5, d, 3)
    ones = np.ones((1, 8), bool)
    pos1, pos2 = np.arange(8)[None], np.arange(5)[None]

    def t(a):
        return torch.from_numpy(np.array(a))

    jcache = jax_llama.init_cache(cfg, 1, t_max, dtype=jnp.float32)
    _, jcache = jax_gen.prefill_full(jm.params["llm"], cfg, jcache, jnp.asarray(emb1),
                                     jnp.asarray([8]), jnp.asarray(ones), jnp.asarray(pos1))
    carried = torch_llama.KVCache(k=t(jcache.k), v=t(jcache.v))
    start, lens, mask2 = np.array([8], np.int32), np.array([5], np.int32), np.ones((1, 5), bool)
    want, _ = jax_gen.prefill_suffix(jm.params["llm"], cfg, jcache, jnp.asarray(emb2),
                                     jnp.asarray(start), jnp.asarray(lens), jnp.asarray(mask2),
                                     jnp.asarray(pos2))
    counter = torch_quant.ACT_I8_PRODUCTS
    counter.reset()
    got, _ = torch_gen.prefill_suffix(tm.params["llm"], cfg, carried, t(emb2), t(start), t(lens),
                                      t(mask2), t(pos2))
    assert counter.count == 7 * cfg.num_layers
    _close(got.numpy(), np.asarray(want))


def test_verify_block_keeps_the_decode_activations(int8_models):
    """A spec_verify block with the flag on gives the flag-off block's
    logits bit for bit and takes no w8a8 product (JAX's act_quant_ok
    default); asked for it, it would."""
    _, tm = int8_models
    cfg = tm.cfg.llm
    off = dataclasses.replace(cfg, int8_prefill_activations=False)
    emb = torch.from_numpy(_embeds(1, 4, cfg.hidden_size, 4))
    pos = torch.arange(4)[None] + 6
    counter = torch_quant.ACT_I8_PRODUCTS
    outs = []
    for c, ok in ((cfg, None), (off, None), (cfg, True)):
        cache = torch_llama.init_cache(cfg, 1, 16, dtype=torch.float32, device="cpu")
        counter.reset()
        with torch.no_grad():
            outs.append(torch_llama.llama_forward(tm.params["llm"], c, emb, position_ids=pos,
                                                  cache=cache, write_slots=pos, spec_verify=True,
                                                  act_quant_ok=ok))
        outs[-1] = (outs[-1], counter.count)
    (flag_on, n_on), (flag_off, n_off), (forced, n_forced) = outs
    assert torch.equal(flag_on, flag_off) and n_on == n_off == 0
    assert n_forced == 7 * cfg.num_layers and not torch.equal(forced, flag_on)


def test_generate_with_w8a8_prefill_matches_jax(int8_models):
    """TEOChat.generate with `int8_prefill_activations`: greedy tokens equal
    to JAX's (a clear argmax), speculation gives the same tokens, and each
    request takes its w8a8 products in its prefill alone: the decode loops
    (captured in CUDA graphs on the card) take none."""
    jm, tm = int8_models
    ids = [[1, 5, IMG, 7, 8, IMG, 9], [1, 3, 4]]
    frames = np.random.RandomState(8).randn(2, 3, 28, 28).astype(np.float32)
    want = jm.generate(ids, frames, GREEDY)
    counter = torch_quant.ACT_I8_PRODUCTS
    layers = tm.cfg.llm.num_layers
    for gen in (GREEDY, dataclasses.replace(GREEDY, speculative_k=2)):
        counter.reset()
        assert tm.generate(ids, frames, gen) == want
        assert counter.count == 7 * layers  # one batched prefill
    off = torch_teochat.TEOChat(
        dataclasses.replace(tm.cfg, llm=dataclasses.replace(tm.cfg.llm,
                                                            int8_prefill_activations=False)),
        tm.params)
    counter.reset()
    off.generate(ids, frames, GREEDY)
    assert counter.count == 0
