"""The port's decoder, int8 quantization and params bridge against the JAX package.

Cached prefill of a ragged right-padded batch, then decode steps that each
write one slot per row, on the same weights and inputs (seeded numpy) in
fp32. Logits are compared to 1e-4 relative; quantization must match bit
for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from teochat_tpu.config import tiny_test_config
from teochat_tpu.models import llama as jax_llama
from teochat_tpu.ops import quant as jax_quant
from teochat_torch.checkpoint.bridge import to_numpy, to_torch
from teochat_torch.models import llama as torch_llama
from teochat_torch.ops import quant as torch_quant
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

RTOL, ATOL = 1e-4, 1e-5
N_DECODE = 3


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def plain_params():
    cfg = tiny_test_config().llm
    return cfg, jax_llama.init_llama(jax.random.PRNGKey(3), cfg)


def test_bridge_round_trip(plain_params):
    _, params = plain_params
    for tree in (params, jax_quant.quantize_llama_params(params)):
        tree = _np_tree(tree)
        _assert_trees_equal(to_numpy(to_torch(tree, "cpu")), tree)
    # bf16 leaves arrive as ml_dtypes arrays and keep their values
    bf = np.asarray(jnp.asarray(_np_tree(params)["embed_tokens"]["embedding"], jnp.bfloat16))
    t = to_torch({"embedding": bf}, "cpu")["embedding"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(t), bf.astype(np.float32))


def test_quantization_is_bitwise_equal(plain_params):
    k = np.random.RandomState(4).randn(3, 64, 48).astype(np.float32)
    k[1, :, 5] = 0.0  # an all-zero channel takes scale 1
    qt = torch_quant.quantize_kernel(torch.from_numpy(k))
    qj = jax_quant.quantize_kernel(jnp.asarray(k))
    _assert_trees_equal(to_numpy(qt), _np_tree(qj))
    np.testing.assert_array_equal(torch_quant.dequantize_kernel(qt).numpy(),
                                  np.asarray(jax_quant.dequantize_kernel(qj)))
    _, params = plain_params
    _assert_trees_equal(
        to_numpy(torch_quant.quantize_llama_params(to_torch(_np_tree(params), "cpu"))),
        _np_tree(jax_quant.quantize_llama_params(params)),
    )


def _run_jax(params, cfg, emb, seq_lens, pad_to, t_max, dec_ids):
    b = emb.shape[0]
    mask = np.arange(pad_to)[None] < seq_lens[:, None]
    pos = np.where(mask, np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    slots = np.where(mask, pos, t_max - 1).astype(np.int32)
    cache = jax_llama.init_cache(cfg, b, t_max, dtype=jnp.float32)
    logits, cache = jax_llama.llama_forward(
        params, cfg, jnp.asarray(emb), position_ids=jnp.asarray(pos), cache=cache,
        write_slots=jnp.asarray(slots),
        kv_mask=jnp.asarray(np.arange(t_max)[None] < seq_lens[:, None]),
        logits_mode="last", last_index=jnp.asarray(seq_lens - 1),
    )
    out = [np.asarray(logits)]
    for step in range(N_DECODE):
        p = (seq_lens + step).astype(np.int32)
        e = jax_llama.embed_tokens(params, jnp.asarray(dec_ids[:, step:step + 1]))
        logits, cache = jax_llama.llama_forward(
            params, cfg, e, position_ids=jnp.asarray(p[:, None]), cache=cache,
            write_slots=jnp.asarray(p[:, None]),
            kv_mask=jnp.asarray(np.arange(t_max)[None] <= p[:, None]),
            logits_mode="last",
        )
        out.append(np.asarray(logits))
    return out


def _run_torch(params, cfg, emb, seq_lens, pad_to, t_max, dec_ids):
    b = emb.shape[0]
    lens = torch.from_numpy(seq_lens)
    mask = torch.arange(pad_to)[None] < lens[:, None]
    pos = torch.where(mask, torch.cumsum(mask, dim=1) - 1, 0)
    cache = torch_llama.init_cache(cfg, b, t_max, dtype=torch.float32, device="cpu")
    logits = torch_llama.llama_forward(
        params, cfg, torch.from_numpy(emb), position_ids=pos, cache=cache,
        write_slots=torch.where(mask, pos, t_max - 1), logits_mode="last",
        last_index=lens - 1,
    )
    out = [logits.numpy()]
    for step in range(N_DECODE):
        p = lens + step
        e = torch_llama.embed_tokens(params, torch.from_numpy(dec_ids[:, step:step + 1]).long())
        logits = torch_llama.llama_forward(
            params, cfg, e, position_ids=p[:, None], cache=cache,
            write_slots=p[:, None], logits_mode="last",
        )
        out.append(logits.numpy())
    return out


@pytest.mark.parametrize("quant,kv_heads", [(None, 4), ("int8", 4), (None, 2)],
                         ids=["plain", "int8", "gqa"])
def test_cached_prefill_then_decode_matches_jax(quant, kv_heads):
    cfg = dataclasses.replace(tiny_test_config().llm, num_kv_heads=kv_heads)
    params = jax_llama.init_llama(jax.random.PRNGKey(5), cfg)
    if quant == "int8":
        params = jax_quant.quantize_llama_params(params)
    rs = np.random.RandomState(6)
    pad_to = 16
    seq_lens = np.array([16, 9, 1], np.int32)  # ragged rows: padded slots hold garbage
    emb = rs.randn(3, pad_to, cfg.hidden_size).astype(np.float32)
    dec_ids = rs.randint(3, cfg.vocab_size, (3, N_DECODE)).astype(np.int32)
    t_max = pad_to + N_DECODE + 1
    want = _run_jax(params, cfg, emb, seq_lens, pad_to, t_max, dec_ids)
    got = _run_torch(to_torch(_np_tree(params), "cpu"), cfg, emb, seq_lens, pad_to, t_max, dec_ids)
    for w, g in zip(want, got):
        assert g.shape == w.shape == (3, 1, cfg.vocab_size)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_unported_options_raise(plain_params):
    """A cache wider than the batch and attend_cache are ported (the serving
    engine's modes, tests/test_torch_engine.py), and so is the w8a8 prefill
    (tests/test_torch_w8a8.py): with `int8_prefill_activations` a decode
    step (S = 1) keeps w8a16 and takes no int8 x int8 product, a prefill
    takes one a projection; what is not ported raises."""
    cfg, params = plain_params
    tparams = to_torch(_np_tree(params), "cpu")
    cache = torch_llama.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    x = torch.zeros(1, 1, cfg.hidden_size)
    one = torch.zeros(1, 1, dtype=torch.long)
    q8 = to_torch(_np_tree(jax_quant.quantize_llama_params(params)), "cpu")
    w8a8 = dataclasses.replace(cfg, int8_prefill_activations=True)
    step = torch.randn(1, 1, cfg.hidden_size, generator=torch.Generator().manual_seed(0))
    counter = torch_quant.ACT_I8_PRODUCTS
    for c in (cfg, w8a8):
        counter.reset()
        cache1 = torch_llama.init_cache(cfg, 1, 8, dtype=torch.float32, device="cpu")
        got = torch_llama.llama_forward(q8, c, step, position_ids=one, cache=cache1,
                                        write_slots=one)
        assert counter.count == 0
        if c is cfg:
            want = got
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch_llama.llama_forward(q8, w8a8, step.expand(1, 3, -1), position_ids=torch.arange(3)[None])
    assert counter.count == 7 * cfg.num_layers  # q, k, v, out, gate, up, down; not the lm_head
    with pytest.raises(ValueError, match="outside a cache of 2 rows"):
        torch_llama.llama_forward(tparams, cfg, torch.zeros(2, 1, cfg.hidden_size),
                                  position_ids=one.expand(2, 1), cache=cache,
                                  write_slots=one.expand(2, 1), cache_row_offset=1)
