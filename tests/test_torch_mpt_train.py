"""LLaVA-MPT training on the port against the JAX package, on the CPU in fp32.

Same weights on both sides (JAX's init, carried across by `bridge.to_torch`)
and the same inputs (seeded numpy). What is held, with its tolerance:
- the flash backward's tile walks with an ALiBi `bias_k` (K4b's and K4c's
  bias branches without a card: `flash_backward_dkv_schedule` /
  `_dq_schedule`) against JAX's `_flash_bwd(..., bias_k, interpret=True)`
  on the o, m and l of JAX's `_flash_fwd_with_residuals`, MHA and multiquery
  at S 256 and S 200 padded as JAX's padded wrapper pads it, with MPT's
  table, a random one and a cache-sized one (each head's last key's bias
  far from 0): GRAD_TOL 1e-4, absolute and relative. In fp32 the sides
  differ by the order of sums, and with the cache-sized table by JAX's
  rounding of the biased scores before it subtracts m (the walk, as the
  kernels, first takes each head's table relative to its last key): half
  an fp32 ulp of the bias, 3e-5 relative at a 1,024-slot cache's -860,
  which moves the gradients by up to 7e-5. A 4,096-slot table's -3,443
  would move them by 2.6e-4: tests/test_torch_mpt.py holds the forward
  twins with that table at its own BIAS_RTOL;
- LoRA on MPT's four flat projections: the leaves' names, shapes, dtypes
  and scales; merge 1e-5; stacking and the adapter count exactly; a
  one-hot route bitwise the single adapter, -1 the base;
- `forward_train` on MPT: the loss 1e-5 relative and every LoRA and
  projector gradient to TRAIN_GRAD_TOL of its leaf's largest, JAX's masked
  plain path against the port's masked plain path; the port with the mask
  dropped (what the card runs: K4a-c with the table) against its masked
  path to 1e-6 of the largest. Each fp32 side differs from a float64 run of
  the port by up to 2.1e-4 of a leaf's largest gradient (JAX's 1.3e-4, the
  port's 2.1e-4, on wqkv's lora_b and the projector, whose gradients come
  back through both layers' attention and the vocab-wide log-softmax), so
  the two are held to 5e-4 of it;
- `train()` for 2 optimizer steps at accumulation 2 against JAX's driver
  (losses to its printed 4 decimals, the trained leaves as
  tests/test_torch_train.py holds them), the vision tokenizer's refusal on
  MPT in both drivers, and `train.cli.main` over a tiny LLaVA-MPT checkpoint
  with a save and a bitwise reload.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from teochat_tpu.config import MptConfig, tiny_test_config
from teochat_tpu.data import dataset as jax_data
from teochat_tpu.models import fusion as jax_fusion
from teochat_tpu.models import teochat as jax_teochat
from teochat_tpu.ops import flash_attention as jax_flash
from teochat_tpu.ops import quant as jax_quant
from teochat_tpu.train import lora as jax_lora
from teochat_tpu.train import trainer as jax_trainer
from teochat_torch.checkpoint.bridge import to_numpy, to_torch
from teochat_torch.data import dataset as torch_data
from teochat_torch.models import fusion as torch_fusion
from teochat_torch.models import mpt as torch_mpt
from teochat_torch.models import teochat as torch_teochat
from teochat_torch.ops import flash_attention as flash_mod
from teochat_torch.train import lora as torch_lora
from teochat_torch.train import trainer as torch_trainer
from tests.test_data_pipeline import MockTokenizer, TinyProcessor, _raw_example
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

IMG = -200
FAST = 1e-5
GRAD_TOL = 1e-4
TRAIN_GRAD_TOL = 5e-4
STEP_REL_L2 = 5e-2  # as tests/test_torch_train.py
MPT_KW = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, expansion_ratio=2,
              max_seq_len=128)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# -------------------------------------------------- the bias twins against JAX


def _table(kind, h, s, rs):
    """[H, S] fp32: MPT's ALiBi table sized to S (each head's last key 0), a
    random table, or the first S keys of MPT's table for a 1,024-slot cache
    (32 heads' slopes, biases down to ~-860, the last key's far from 0): a
    row-strided view, as mpt_forward slices a cache-sized table."""
    if kind == "mpt":
        return torch_mpt.alibi_bias(h, s)[0, :, 0, :]
    if kind == "random":
        return torch.from_numpy((rs.randn(h, s) * 2).astype(np.float32))
    return torch_mpt.alibi_bias(32, 1024)[0, :h, 0, :s]


def _jax_backward(q, k, v, do, bias):
    """JAX's K4a residuals and K4b / K4c with bias_k in interpret mode, S
    padded to the 128-row tile (the bias with zeros) as JAX's padded
    wrapper pads it, sliced back: (o, m, l, dq, dk, dv) in [B, S, H, D] and
    [B, H, S]."""
    s = q.shape[1]
    pad = -s % 128
    bhsd = [jnp.asarray(np.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0)))).transpose(0, 2, 1, 3)
            for x in (q, k, v, do)]
    bp = jnp.asarray(np.pad(bias, ((0, 0), (0, pad))))
    kw = dict(causal=True, scale=q.shape[-1] ** -0.5, block_q=128, block_k=128, interpret=True)
    o, m, l = jax_flash._flash_fwd_with_residuals(*bhsd[:3], bp, **kw)
    dq, dk, dv = jax_flash._flash_bwd(*bhsd[:3], o, m, l, bhsd[3], bp, **kw)
    back = [np.asarray(x.transpose(0, 2, 1, 3))[:, :s] for x in (o, dq, dk, dv)]
    return back[0], np.asarray(m)[:, :, :s, 0], np.asarray(l)[:, :, :s, 0], *back[1:]


@pytest.mark.parametrize("b,s,h,hkv", [(1, 256, 2, 2), (1, 256, 2, 1), (2, 200, 2, 2)],
                         ids=["mha", "multiquery", "ragged-padded"])
def test_bias_walks_match_jax_backward(b, s, h, hkv):
    """K4b's and K4c's walks with each table, on JAX's o, m and l, against
    JAX's backward kernels; the forward walk's m and l against JAX's K4a."""
    d = 64
    rs = np.random.RandomState(s + hkv)
    q, do = ((rs.randn(b, s, h, d) * sc).astype(np.float32) for sc in (0.3, 1.0))
    k, v = ((rs.randn(b, s, hkv, d) * sc).astype(np.float32) for sc in (0.3, 1.0))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    for kind in ("mpt", "random", "cache"):
        bias = _table(kind, h, s, rs)
        tol = GRAD_TOL
        o, m, l, *want = _jax_backward(q, k, v, do, bias.numpy())
        _, wm, wl = flash_mod.flash_forward_schedule(tq, tk, tv, bias_k=bias)
        np.testing.assert_allclose(wm.numpy(), m, rtol=tol, atol=tol, err_msg=f"m {kind}")
        np.testing.assert_allclose(wl.numpy(), l, rtol=tol, atol=0, err_msg=f"l {kind}")
        tm, tl = torch.from_numpy(m.copy()), torch.from_numpy(l.copy())
        di = flash_mod.flash_di_plain(torch.from_numpy(o), tdo)
        dk, dv = flash_mod.flash_backward_dkv_schedule(tq, tk, tv, tdo, tm, tl, di, bias_k=bias)
        dq = flash_mod.flash_backward_dq_schedule(tq, tk, tv, tdo, tm, tl, di, bias_k=bias)
        for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol, err_msg=f"{name} {kind}")


def test_bias_walks_shift_by_each_heads_last_bias():
    """Adding a constant to a head's table moves neither the forward walk's o
    and l (softmax is shift-invariant and the walk takes the table relative
    to its last key) nor, beyond m's rounding, the backward walks'
    gradients; m moves by the constant. m leaves in natural units, bref
    added back as K4a adds it, so at -1,500 it carries half an fp32 ulp
    (6e-5), which the backward's m - bref keeps: GRAD_TOL."""
    rs = np.random.RandomState(3)
    b, s, h, d = 1, 130, 2, 64
    q, k, v, do = (torch.from_numpy((rs.randn(b, s, h, d) * 0.3).astype(np.float32))
                   for _ in range(4))
    bias = torch_mpt.alibi_bias(h, s)[0, :, 0, :]
    shift = torch.tensor([[-700.0], [-1500.0]])
    outs = []
    for table in (bias, bias + shift):
        o, m, l = flash_mod.flash_forward_schedule(q, k, v, bias_k=table)
        di = flash_mod.flash_di_plain(o, do)
        outs.append((o, m, l, *flash_mod.flash_backward_dkv_schedule(q, k, v, do, m, l, di,
                                                                      bias_k=table),
                     flash_mod.flash_backward_dq_schedule(q, k, v, do, m, l, di, bias_k=table)))
    (o0, m0, l0, *g0), (o1, m1, l1, *g1) = outs
    torch.testing.assert_close(o1, o0, rtol=0, atol=0)
    torch.testing.assert_close(l1, l0, rtol=0, atol=0)
    torch.testing.assert_close(m1 - shift[None], m0, rtol=0, atol=1e-3)
    for a, w in zip(g1, g0):
        torch.testing.assert_close(a, w, rtol=GRAD_TOL, atol=GRAD_TOL)


# ------------------------------------------------------------- LoRA on MPT


@pytest.fixture(scope="module")
def tiny_mpt():
    """A tiny LLaVA-MPT: the JAX config (both packages read it) and JAX's init."""
    base = dataclasses.replace(tiny_test_config(vocab_size=MPT_KW["vocab_size"]), dtype="float32")
    cfg = dataclasses.replace(base, llm=MptConfig(**MPT_KW), llm_backend="mpt")
    return cfg, _np(jax_teochat.init_teochat(jax.random.PRNGKey(21), cfg))


def _random_lora_b(llm, seed):
    """LoRA B drawn nonzero on MPT's four projections."""
    rs = np.random.RandomState(seed)
    llm = _np(llm)
    for name in jax_lora.MPT_TARGET_NAMES:
        proj = llm["layers"][name]
        proj["lora_b"] = (rs.randn(*proj["lora_b"].shape) * 0.05).astype(np.float32)
    return llm


def test_add_lora_params_on_mpt_matches_jax(tiny_mpt):
    """The adapters go on wqkv, out_proj, up_proj and down_proj, as JAX's:
    the same tree, shapes, dtypes and scales; A ~ N(0, 1/r) from the
    generator, B zero; the backbone leaves shared; merge_lora folds them as
    JAX's does, and refuses an int8 backbone."""
    cfg, params = tiny_mpt
    assert torch_lora.MPT_TARGET_NAMES == jax_lora.MPT_TARGET_NAMES
    jl = _np(jax_lora.add_lora_params(jax.random.PRNGKey(2), params["llm"], rank=8, alpha=16.0))
    base = to_torch(params["llm"], "cpu")
    tl = torch_lora.add_lora_params(torch.Generator().manual_seed(2), base, rank=8, alpha=16.0)
    got = to_numpy(tl)
    assert jax.tree.structure(got) == jax.tree.structure(jl)
    for w, g in zip(jax.tree.leaves(jl), jax.tree.leaves(got)):
        assert (g.shape, g.dtype) == (w.shape, w.dtype)
    for name in jax_lora.MPT_TARGET_NAMES:
        proj = got["layers"][name]
        assert abs(proj["lora_a"].std() * np.sqrt(8) - 1) < 0.1 and not proj["lora_b"].any()
        np.testing.assert_array_equal(proj["lora_scale"], jl["layers"][name]["lora_scale"])
        assert tl["layers"][name]["kernel"] is base["layers"][name]["kernel"]
    assert "lora_a" not in got["layers"]["norm1"]
    lora = _random_lora_b(jl, seed=3)
    merged_j = _np(jax_lora.merge_lora(lora))
    merged_t = to_numpy(torch_lora.merge_lora(to_torch(lora, "cpu")))
    assert jax.tree.structure(merged_t) == jax.tree.structure(merged_j)
    for w, g in zip(jax.tree.leaves(merged_j), jax.tree.leaves(merged_t)):
        np.testing.assert_allclose(g, w, rtol=FAST, atol=FAST)
    int8 = _np(jax_lora.add_lora_params(jax.random.PRNGKey(2),
                                        jax_quant.quantize_mpt_params(params["llm"]), rank=4))
    with pytest.raises(ValueError, match="int8"):
        torch_lora.merge_lora(to_torch(int8, "cpu"))


def test_stacked_mpt_adapters_match_jax_and_route_per_row(tiny_mpt):
    """stack_lora_adapters and num_stacked_adapters on MPT trees equal JAX's
    (the bridge carries the stacked leaves, fp32); through mpt_forward a
    one-hot route is bitwise the single adapter and a -1 row the base."""
    cfg, params = tiny_mpt
    trees = [_random_lora_b(jax_lora.add_lora_params(jax.random.PRNGKey(i), params["llm"],
                                                     rank=4, alpha=8.0), seed=i)
             for i in (4, 5)]
    want = _np(jax_lora.stack_lora_adapters(trees))
    single = [to_torch(t, "cpu") for t in trees]
    stacked = torch_lora.stack_lora_adapters(single)
    got = to_numpy(stacked)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert stacked["layers"]["wqkv"]["lora_a"].dtype == torch.float32
    assert torch_lora.num_stacked_adapters(stacked) == jax_lora.num_stacked_adapters(want) == 2
    assert (torch_lora.num_stacked_adapters(single[0])
            == jax_lora.num_stacked_adapters(trees[0]) == 0)
    assert torch_lora.num_stacked_adapters(to_torch(params["llm"], "cpu")) == 0

    embeds = torch.from_numpy(np.random.RandomState(6).randn(3, 9, 64).astype(np.float32))
    route = torch_lora.adapter_route([1, -1, 0], 2)
    with torch.no_grad():
        mixed = torch_mpt.mpt_forward(stacked, cfg.llm, embeds, adapter_route=route)
        for row, tree in ((0, single[1]), (1, to_torch(params["llm"], "cpu")), (2, single[0])):
            alone = torch_mpt.mpt_forward(tree, cfg.llm, embeds[row:row + 1])
            assert torch.equal(mixed[row:row + 1], alone), row


# --------------------------------------------------------- forward_train


def _batch(cfg, seed):
    """A right-padded 2-row batch of different lengths: ids with a frame
    sentinel, labels on the answers."""
    rs = np.random.RandomState(seed)
    ids, labels = [], []
    for n in (9, 5):
        row = [1] + rs.randint(3, cfg.llm.vocab_size, n).tolist()
        row[2] = IMG
        ids.append(row)
        labels.append([-100] * 4 + row[4:])
    kw = dict(labels=labels, tokens_per_frame=cfg.vision.num_patches, pad_to=24)
    pixels = rs.randn(2, 3, cfg.vision.image_size, cfg.vision.image_size).astype(np.float32)
    return (jax_fusion.build_fusion_plan(ids, **kw), torch_fusion.build_fusion_plan(ids, **kw),
            pixels)


def _trainable_params(params, quant, seed):
    llm = params["llm"]
    if quant == "int8":
        llm = jax_quant.quantize_mpt_params(llm)
    llm = _random_lora_b(jax_lora.add_lora_params(jax.random.PRNGKey(seed), llm, rank=4), seed)
    return {**params, "llm": llm}


@pytest.mark.parametrize("quant,remat", [(None, False), ("int8", True)],
                         ids=["float", "int8-remat"])
def test_mpt_forward_train_matches_jax(tiny_mpt, quant, remat):
    """The loss and the LoRA and projector gradients against
    jax.value_and_grad of JAX's forward_train (its MPT branch: the masked
    plain attention); the port's masked plain path (the CPU's) and its path
    with the right-padding mask dropped (the card's: K4a-c with the table,
    whose CPU twin is the plain attention without the mask) both agree."""
    cfg, params = tiny_mpt
    params = _trainable_params(params, quant, seed=7)
    jplan, tplan, pixels = _batch(cfg, seed=8)
    assert len(set(tplan.seq_lens.tolist())) == 2 and (tplan.attention_mask == 0).any()
    trainable, frozen = jax_trainer.partition_params(
        jax.tree.map(jnp.asarray, params), jax_lora.lora_trainable_filter)
    jloss, jgrads = jax.value_and_grad(lambda t: jax_teochat.forward_train(
        jax_trainer.combine_params(t, frozen), cfg, jplan, jnp.asarray(pixels), remat=remat))(
        trainable)
    want = dict(torch_trainer.tree_leaves_with_path(_np(jgrads)))

    tparams = to_torch(params, "cpu")
    leaves = dict(torch_trainer.tree_leaves_with_path(
        torch_trainer.partition_params(tparams, jax_lora.lora_trainable_filter)[0]))
    assert sorted(want) == sorted(leaves) and len(leaves) == 2 * 4 + 4
    for x in leaves.values():
        x.requires_grad_(True)
    runs = {}
    for impl in ("auto", "flash"):
        tloss = torch_teochat.forward_train(tparams, cfg, tplan, torch.from_numpy(pixels),
                                            remat=remat, attn_impl=impl)
        runs[impl] = (tloss.item(), torch.autograd.grad(tloss, list(leaves.values())))
    np.testing.assert_allclose(runs["auto"][0], float(jloss), rtol=FAST)
    np.testing.assert_allclose(runs["flash"][0], runs["auto"][0], rtol=1e-6)
    for (path, _), g, g_flash in zip(leaves.items(), runs["auto"][1], runs["flash"][1]):
        top = np.abs(want[path]).max()
        assert top > 0, path
        np.testing.assert_allclose(g.numpy(), want[path], rtol=0, atol=TRAIN_GRAD_TOL * top,
                                   err_msg=path)
        np.testing.assert_allclose(g_flash.numpy(), g.numpy(), rtol=0, atol=1e-6 * top,
                                   err_msg=path)


# ------------------------------------------------------------- train()


class _GrowingTokenizer(MockTokenizer):
    """MockTokenizer that can grow, as the vision tokenizer needs."""

    def add_tokens(self, tokens, special_tokens=False):
        new = [t for t in tokens if t not in self.vocab]
        for t in new:
            self.vocab[t] = len(self.vocab) + 10
        return len(new)

    def __len__(self):
        return len(self.vocab) + 10


def test_mpt_train_matches_jax_driver(tiny_mpt, tmp_path, capsys, monkeypatch):
    """Both drivers' train() on the same LLaVA-MPT weights and adapters (LoRA
    over the decoder, the projector in its own group, accumulation 2): the
    same printed losses and trained leaves; with a tokenizer that can grow
    and mm_use_im_patch_token, JAX's driver fails in its vision tokenizer on
    MPT's tree (no embed_tokens) and the port's raises a ValueError naming
    it."""
    from teochat_tpu.train import train as jax_train_mod
    from teochat_torch.train import train as torch_train_mod

    cfg, params = tiny_mpt
    data = [_raw_example(2, s) for s in range(8)]
    common = dict(per_device_train_batch_size=2, gradient_accumulation_steps=2,
                  learning_rate=1e-3, mm_projector_lr=2e-3, logging_steps=1, bf16=False,
                  lora_r=4, lora_alpha=8.0, seed=3, gradient_checkpointing=True)
    steps = 2

    jargs = jax_train_mod.TrainingArguments(output_dir=str(tmp_path), report_to="none",
                                            save_strategy="no", **common)
    capsys.readouterr()
    jstate = jax_train_mod.train(
        jax_train_mod.ModelArguments(), jax_data.DataArguments(image_processor=TinyProcessor()),
        jargs, cfg=cfg, params=params, tokenizer=MockTokenizer(), dataset=data,
        max_steps_override=steps)
    jlosses = [float(x) for x in re.findall(r"step \d+/\d+ loss ([0-9.]+)",
                                            capsys.readouterr().out)]

    jax_adapters = _np(jax_lora.add_lora_params(jax.random.PRNGKey(3), params["llm"], rank=4,
                                                alpha=8.0))
    monkeypatch.setattr(torch_train_mod, "add_lora_params",
                        lambda gen, llm, rank, alpha: to_torch(jax_adapters, "cpu"))
    history = []
    targs = dict(report_to="none", save_strategy="no", **common)
    tstate = torch_train_mod.train(
        torch_train_mod.ModelArguments(), torch_data.DataArguments(image_processor=TinyProcessor()),
        torch_train_mod.TrainingArguments(output_dir=str(tmp_path / "torch"), **targs),
        cfg=cfg, params=to_torch(params, "cpu"), tokenizer=MockTokenizer(), dataset=data,
        max_steps_override=steps, history=history)
    assert len(jlosses) == len(history) == steps
    np.testing.assert_allclose([h["loss"] for h in history], jlosses, rtol=0, atol=5e-5 + 1e-6)

    before = dict(torch_trainer.tree_leaves_with_path({**params, "llm": jax_adapters}))
    got = dict(torch_trainer.tree_leaves_with_path(to_numpy(tstate.params)))
    want = dict(torch_trainer.tree_leaves_with_path(_np(jstate.params)))
    assert sorted(got) == sorted(want) == sorted(before)
    for path, b in before.items():
        if not jax_lora.lora_trainable_filter(path):
            np.testing.assert_array_equal(got[path], b, err_msg=path)
            continue
        dw, dg = want[path] - b, got[path] - b
        assert np.linalg.norm(dg - dw) <= STEP_REL_L2 * np.linalg.norm(dw), path
    assert np.abs(got["llm/layers/down_proj/lora_b"]).max() > 0

    grow = dict(mm_use_im_patch_token=True)
    with pytest.raises(KeyError, match="embed_tokens"):
        jax_train_mod.train(
            jax_train_mod.ModelArguments(**grow),
            jax_data.DataArguments(image_processor=TinyProcessor()), jargs, cfg=cfg,
            params=params, tokenizer=_GrowingTokenizer(), dataset=data, max_steps_override=1)
    with pytest.raises(ValueError, match="vision tokenizer"):
        torch_train_mod.train(
            torch_train_mod.ModelArguments(**grow),
            torch_data.DataArguments(image_processor=TinyProcessor()),
            torch_train_mod.TrainingArguments(output_dir=str(tmp_path / "grow"), **targs),
            cfg=cfg, params=to_torch(params, "cpu"), tokenizer=_GrowingTokenizer(),
            dataset=data, max_steps_override=1)
    assert not (tmp_path / "grow").exists()  # nothing was saved


def test_mesh_sequence_on_mpt_fails_as_in_jax(tiny_mpt, tmp_path):
    """ROADMAP F11: JAX's driver turns the ring on by replacing
    `sequence_axis` in the decoder's config, a field MptConfig does not
    have, so `--mesh_sequence 2` on LLaVA-MPT (its 8 virtual devices: a
    mesh of fsdp 4 x sequence 2) raises a TypeError before its first step.
    The port raises a ValueError naming the flag and MPT, before anything
    is saved."""
    from teochat_tpu.config import MeshConfig as JaxMeshConfig
    from teochat_tpu.train import train as jax_train_mod
    from teochat_torch.config import MeshConfig
    from teochat_torch.train import train as torch_train_mod

    cfg, params = tiny_mpt
    data = [_raw_example(2, s) for s in range(4)]
    common = dict(per_device_train_batch_size=2, bf16=False, lora_r=4, lora_alpha=8.0,
                  report_to="none", save_strategy="no", lr_scheduler_type="constant")
    jargs = jax_train_mod.TrainingArguments(
        output_dir=str(tmp_path / "jax"), mesh=JaxMeshConfig(fsdp=-1, sequence=2), **common)
    with pytest.raises(TypeError, match="sequence_axis"):
        jax_train_mod.train(
            jax_train_mod.ModelArguments(), jax_data.DataArguments(image_processor=TinyProcessor()),
            jargs, cfg=cfg, params=params, tokenizer=MockTokenizer(), dataset=data,
            max_steps_override=1)
    out = tmp_path / "torch"
    targs = torch_train_mod.TrainingArguments(
        output_dir=str(out), mesh=MeshConfig(fsdp=-1, sequence=2), **common)
    with pytest.raises(ValueError, match="--mesh_sequence 2: ring attention runs the LLaMA"):
        torch_train_mod.train(
            torch_train_mod.ModelArguments(),
            torch_data.DataArguments(image_processor=TinyProcessor()), targs, cfg=cfg,
            params=to_torch(params, "cpu"), tokenizer=MockTokenizer(), dataset=data,
            max_steps_override=1)
    assert not out.exists()  # nothing was saved


def test_cli_trains_an_mpt_checkpoint(tmp_path):
    """train.cli.main over a tiny LLaVA-MPT checkpoint (an "mpt" name: the
    `builder._load_mpt_model`, which ignores allow_partial as JAX's does),
    8-bit with LoRA r4, 2 steps and a save each step: finite losses, the
    int8 kernels unchanged, every adapter and the projector moved, the saved
    checkpoint read back bitwise; then a run to step 3 resumes from it."""
    from teochat_torch import builder as torch_builder
    from teochat_torch.checkpoint import orbax_io
    from teochat_torch.train import cli as torch_cli
    from tests.test_torch_builder import _tiny_tower_config
    from tests.test_torch_mpt import _write_llava_mpt
    from teochat_torch.conversation import conv_templates
    from tests.test_torch_train_cli import QUESTION, _dataset_dir, _word_tokenizer

    path = _write_llava_mpt(tmp_path / "llava-mpt-tiny", patch_token=False)
    v1 = conv_templates["v1"]
    _word_tokenizer(path, [v1.system, *v1.roles, QUESTION, "Image 1 2 3 in chronological order",
                           "airport dam factory"])
    data = _dataset_dir(tmp_path / "data", 4)
    out = str(tmp_path / "out")
    argv = (f"--bits 8 --lora_enable True --lora_r 4 --lora_alpha 8 --model_name_or_path {path} "
            f"--version v1 --data_name {data} --data_split train "
            f"--data_cache_dir {tmp_path / 'cache'} --mm_use_im_start_end False "
            f"--mm_use_im_patch_token False --bf16 False --output_dir {out} "
            f"--num_train_epochs 1 --per_device_train_batch_size 2 --save_steps 1 "
            f"--save_total_limit 1 --learning_rate 1e-2 --warmup_ratio 0 --logging_steps 1 "
            f"--gradient_checkpointing True --mpt_attn_impl triton --report_to none "
            f"--max_steps 2 --device cpu").split()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HF_DATASETS_OFFLINE", "1")
        mp.setenv("HF_HUB_OFFLINE", "1")
        mp.setenv("HF_HOME", str(tmp_path / "hf"))
        mp.setattr(torch_builder, "load_config", _tiny_tower_config(torch_builder.load_config))
        _, base, _, _ = torch_builder.load_pretrained_model(path, None, "llava-mpt-tiny",
                                                            load_8bit=True, device="cpu")
        history, resumed = [], []
        state = torch_cli.main(argv, history=history)
        saved, saved_cfg, _ = orbax_io.load_checkpoint(os.path.join(out, "checkpoint-2"))
        torch_cli.main([*argv[:-4], "--max_steps", "3", "--device", "cpu"], history=resumed)
    assert [h["step"] for h in resumed] == [3] and np.isfinite(resumed[0]["loss"])
    assert sorted(os.listdir(out)) == ["checkpoint-3"]
    assert len(history) == 2 and all(np.isfinite(h["loss"]) and h["loss"] > 0 for h in history)
    params = state.params
    before = dict(torch_trainer.tree_leaves_with_path(base.params))
    for path_, x in torch_trainer.tree_leaves_with_path(params):
        if "lora_" in path_:
            continue
        if path_.startswith("projector/"):
            assert not torch.equal(x, before[path_].float()), path_
        else:
            assert torch.equal(x, before[path_]), path_
    for name in torch_lora.MPT_TARGET_NAMES:
        assert params["llm"]["layers"][name]["kernel"].dtype == torch.int8
        assert params["llm"]["layers"][name]["lora_b"].abs().max() > 0, name
    assert saved_cfg.llm_backend == "mpt" and torch_mpt.is_mpt_params(saved["llm"])
    want = dict(torch_trainer.tree_leaves_with_path(params))
    got = dict(torch_trainer.tree_leaves_with_path(saved))
    assert sorted(got) == sorted(want)
    for path_, x in got.items():
        assert x.dtype == want[path_].dtype and torch.equal(x, want[path_].cpu()), path_
