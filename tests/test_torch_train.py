"""The port's training path against the JAX package, on the CPU in fp32.

Same weights on both sides (JAX init, carried over through the bridge) and
the same inputs (seeded numpy); LoRA B is drawn nonzero where a test needs
every adapter to get a gradient. Tolerances, with their reasons:
- LoRA `_proj` and `merge_lora`: 1e-5 (one or two fp32 products);
- `forward_train` loss 1e-5 relative, trainable gradients 1e-4 (three
  decoder layers and a vocab-wide log-softmax summed in another order);
- the optimizer alone, fed the same gradients as optax: 1e-6;
- 3 optimizer steps (projector group, accumulation 2): per-micro-batch
  losses 1e-5 relative; each leaf's change 5e-2 relative L2 and every
  frozen leaf unchanged. Adam moves an element by about lr whatever the
  size of its gradient, and in the tiny model some adapter gradients are
  below fp32 noise (1e-8 against 1e-1), so those elements step in a
  direction set by rounding on either side; the losses after the updates
  show that the rest agree;
- `preprocess`, the dataset and the collator: exact;
- `train()` end to end: the JAX driver prints each loss with 4 decimals, so
  the port's must round to the same digits (5e-5); the trained parameters
  are held as above.
"""

import dataclasses
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from teochat_tpu.config import tiny_test_config
from teochat_tpu.data import dataset as jax_data
from teochat_tpu.models import fusion as jax_fusion
from teochat_tpu.models import llama as jax_llama
from teochat_tpu.models import teochat as jax_teochat
from teochat_tpu.ops import quant as jax_quant
from teochat_tpu.train import lora as jax_lora
from teochat_tpu.train import trainer as jax_trainer
from teochat_torch.checkpoint.bridge import to_numpy, to_torch
from teochat_torch.data import dataset as torch_data
from teochat_torch.models import fusion as torch_fusion
from teochat_torch.models import llama as torch_llama
from teochat_torch.models import teochat as torch_teochat
from teochat_torch.train import lora as torch_lora
from teochat_torch.train import trainer as torch_trainer
from tests.test_data_pipeline import MockTokenizer, TinyProcessor, _raw_example
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

IMG = -200
FAST = 1e-5
STEP_REL_L2 = 5e-2


def _assert_same_updates(got_params, want_params, before, all_moved=True):
    """Frozen leaves unchanged on both sides; each trained leaf's change agrees
    to STEP_REL_L2 (relative L2), and is nonzero where `all_moved`."""
    leaves = dict(torch_trainer.tree_leaves_with_path(before))
    got = dict(torch_trainer.tree_leaves_with_path(to_numpy(got_params)))
    want = dict(torch_trainer.tree_leaves_with_path(_np(want_params)))
    assert sorted(got) == sorted(want) == sorted(leaves)
    for path, b in leaves.items():
        b = np.asarray(b)
        if not jax_lora.lora_trainable_filter(path):
            np.testing.assert_array_equal(got[path], b, err_msg=path)
            np.testing.assert_array_equal(want[path], b, err_msg=path)
            continue
        dw, dg = want[path] - b, got[path] - b
        assert np.abs(dw).max() > 0 or not all_moved, path
        assert np.linalg.norm(dg - dw) <= STEP_REL_L2 * np.linalg.norm(dw), path


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _random_lora_b(llm, seed):
    """LoRA B drawn nonzero, so every adapter has a gradient and an effect."""
    rs = np.random.RandomState(seed)
    llm = _np(llm)
    for group in jax_lora.LORA_TARGET_GROUPS:
        for proj in llm["layers"][group].values():
            proj["lora_b"] = (rs.randn(*proj["lora_b"].shape) * 0.05).astype(np.float32)
    return llm


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_test_config(vocab_size=128)
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, num_kv_heads=2))
    return cfg, jax_teochat.init_teochat(jax.random.PRNGKey(11), cfg)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_lora_proj_matches_jax(quant):
    rs = np.random.RandomState(1)
    p = {"kernel": (rs.randn(24, 40) * 0.1).astype(np.float32)}
    if quant:
        p = _np(jax_quant.quantize_kernel(jnp.asarray(p["kernel"])))
    p.update(lora_a=rs.randn(24, 8).astype(np.float32) * 0.3,
             lora_b=rs.randn(8, 40).astype(np.float32) * 0.3,
             lora_scale=np.float32(2.0))
    x = rs.randn(2, 5, 24).astype(np.float32)

    def jloss(x, a, b):
        y = jax_llama._proj(x, {**p, "lora_a": a, "lora_b": b})
        return jnp.sum(jnp.sin(y)), y

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(p["lora_a"]), jnp.asarray(p["lora_b"]))
    tp = to_torch(p, "cpu")
    tx = torch.from_numpy(x).requires_grad_(True)
    for name in ("lora_a", "lora_b"):
        tp[name].requires_grad_(True)
    got = torch_llama._proj(tx, tp)
    torch.sin(got).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=FAST, atol=FAST)
    for g, w in zip((tx.grad, tp["lora_a"].grad, tp["lora_b"].grad), jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=FAST, atol=FAST)
    assert tp["lora_scale"].grad is None  # lora_scale takes no gradient


def test_add_lora_params_and_merge_match_jax(tiny):
    cfg, params = tiny
    jl = jax_lora.add_lora_params(jax.random.PRNGKey(2), params["llm"], rank=8, alpha=16.0)
    gen = torch.Generator().manual_seed(2)
    tl = torch_lora.add_lora_params(gen, to_torch(_np(params["llm"]), "cpu"), rank=8, alpha=16.0)
    want, got = _np(jl), to_numpy(tl)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert (g.shape, g.dtype) == (w.shape, w.dtype)
    a = got["layers"]["attn"]["q"]["lora_a"]
    assert abs(a.std() * np.sqrt(8) - 1) < 0.1 and not got["layers"]["mlp"]["up"]["lora_b"].any()
    # merge: the same adapters on both sides
    lora = _random_lora_b(jl, seed=3)
    merged_j = _np(jax_lora.merge_lora(lora))
    merged_t = to_numpy(torch_lora.merge_lora(to_torch(lora, "cpu")))
    assert jax.tree.structure(merged_t) == jax.tree.structure(merged_j)
    for w, g in zip(jax.tree.leaves(merged_j), jax.tree.leaves(merged_t)):
        np.testing.assert_allclose(g, w, rtol=FAST, atol=FAST)
    with pytest.raises(ValueError, match="int8"):
        torch_lora.merge_lora(to_torch(_np(jax_lora.add_lora_params(
            jax.random.PRNGKey(2), jax_quant.quantize_llama_params(params["llm"]), rank=4)), "cpu"))


def _batch(cfg, seed):
    """A right-padded 2-row batch: ids with frame sentinels, labels on the answers."""
    rs = np.random.RandomState(seed)
    ids, labels = [], []
    for n in (9, 6):
        row = [1] + rs.randint(3, cfg.llm.vocab_size, n).tolist()
        row[2] = IMG
        lab = [-100] * 4 + row[4:]
        ids.append(row)
        labels.append(lab)
    n_frames = sum(r.count(IMG) for r in ids)
    tpf = cfg.vision.num_patches
    kw = dict(labels=labels, tokens_per_frame=tpf, pad_to=24)
    pixels = rs.randn(n_frames, 3, cfg.vision.image_size, cfg.vision.image_size).astype(np.float32)
    return (jax_fusion.build_fusion_plan(ids, **kw), torch_fusion.build_fusion_plan(ids, **kw),
            pixels)


def _trainable_params(params, quant, seed):
    llm = params["llm"]
    if quant == "int8":
        llm = jax_quant.quantize_llama_params(llm)
    llm = _random_lora_b(jax_lora.add_lora_params(jax.random.PRNGKey(seed), llm, rank=4), seed)
    return {**_np(params), "llm": llm}


@pytest.mark.parametrize("quant,remat", [("int8", False), ("int8", True), (None, False),
                                         (None, True)],
                         ids=["int8", "int8-remat", "float", "float-remat"])
def test_forward_train_loss_and_gradients_match_jax(tiny, quant, remat):
    cfg, params = tiny
    params = _trainable_params(params, quant, seed=4)
    jplan, tplan, pixels = _batch(cfg, seed=5)

    trainable, frozen = jax_trainer.partition_params(
        jax.tree.map(jnp.asarray, params), jax_lora.lora_trainable_filter)
    jloss, jgrads = jax.value_and_grad(lambda t: jax_teochat.forward_train(
        jax_trainer.combine_params(t, frozen), cfg, jplan, jnp.asarray(pixels), remat=remat))(
        trainable)

    tparams = to_torch(params, "cpu")
    leaves = dict(torch_trainer.tree_leaves_with_path(
        torch_trainer.partition_params(tparams, jax_lora.lora_trainable_filter)[0]))
    for x in leaves.values():
        x.requires_grad_(True)
    tloss = torch_teochat.forward_train(tparams, cfg, tplan, torch.from_numpy(pixels),
                                        remat=remat)
    tgrads = torch.autograd.grad(tloss, list(leaves.values()))

    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=FAST)
    want = dict(torch_trainer.tree_leaves_with_path(_np(jgrads)))
    assert sorted(want) == sorted(leaves) and len(leaves) == 2 * 7 + 4
    for (path, _), g in zip(leaves.items(), tgrads):
        assert np.abs(want[path]).max() > 0, path
        np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-4, atol=1e-4, err_msg=path)


def test_three_steps_with_projector_group_and_accumulation_match_jax(tiny):
    cfg, params = tiny
    params = _trainable_params(params, "int8", seed=6)
    batches = [_batch(cfg, seed=10 + i) for i in range(6)]  # 3 updates x accumulation 2
    opt_kw = dict(projector_lr=2e-3, total_steps=3, max_grad_norm=1.0,
                  lr_scheduler_type="cosine", weight_decay=0.01)

    jopt = optax.MultiSteps(jax_trainer.make_optimizer(1e-3, **opt_kw), every_k_schedule=2)
    jstate = jax_trainer.init_train_state(
        jax.tree.map(jnp.asarray, params), jopt, jax_lora.lora_trainable_filter)
    jstep = jax_trainer.make_train_step(cfg, jopt, trainable_filter=jax_lora.lora_trainable_filter)
    jlosses = []
    for jplan, _, pixels in batches:
        jstate, loss = jstep(jstate, jplan, jnp.asarray(pixels))
        jlosses.append(float(loss))

    topt = torch_trainer.MultiSteps(torch_trainer.make_optimizer(1e-3, **opt_kw), 2)
    tstate = torch_trainer.init_train_state(to_torch(params, "cpu"), topt,
                                            jax_lora.lora_trainable_filter)
    tstep = torch_trainer.make_train_step(cfg, topt,
                                          trainable_filter=jax_lora.lora_trainable_filter)
    tlosses = []
    for _, tplan, pixels in batches:
        tstate, loss = tstep(tstate, tplan, torch.from_numpy(pixels))
        tlosses.append(loss.item())

    assert tstate.step == int(jstate.step) == 6
    np.testing.assert_allclose(tlosses, jlosses, rtol=FAST)
    _assert_same_updates(tstate.params, jstate.params, params)


def test_optimizer_matches_optax_on_the_same_gradients():
    """clip (on and off), two groups, weight decay, accumulation 2, warmup:
    the port's in-place update against the optax chain, fed identical grads."""
    rs = np.random.RandomState(7)
    params = {"llm": {"w": rs.randn(6, 5).astype(np.float32)},
              "projector": {"layers": [{"kernel": rs.randn(4, 3).astype(np.float32)}]}}
    # gradient sizes straddle max_grad_norm = 1, so the clip fires on some calls
    grads = [jax.tree.map(lambda x, s=s: (rs.randn(*x.shape) * s).astype(np.float32), params)
             for s in (0.02, 0.5, 0.03, 0.01, 1.0, 0.2)]
    kw = dict(projector_lr=3e-3, total_steps=3, weight_decay=0.05, max_grad_norm=1.0)
    jopt = optax.MultiSteps(jax_trainer.make_optimizer(1e-3, **kw), every_k_schedule=2)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    topt = torch_trainer.MultiSteps(torch_trainer.make_optimizer(1e-3, **kw), 2)
    tp = to_torch(params, "cpu")
    tstate = topt.init(tp)
    tleaves = dict(torch_trainer.tree_leaves_with_path(tp))
    for g in grads:
        u, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, u)
        topt.step(tleaves, {p: torch.from_numpy(x)
                            for p, x in torch_trainer.tree_leaves_with_path(g)}, tstate)
    for w, t in zip(jax.tree.leaves(_np(jp)), jax.tree.leaves(to_numpy(tp))):
        np.testing.assert_allclose(t, w, rtol=1e-6, atol=1e-6)
    assert not np.array_equal(to_numpy(tp)["llm"]["w"], params["llm"]["w"])


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant", "constant_with_warmup"])
def test_schedules_match_optax(kind):
    """The lr of each update, count evaluated before its increment (0 at the
    first update under warmup), past the end of the schedule too."""
    want = _optax_lrs(kind)
    got = [torch_trainer.make_schedule(3e-4, kind, 20, warmup_ratio=0.1)(c) for c in range(22)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-10)  # optax works in float32
    assert got[0] == 0.0 or kind == "constant"


def _optax_lrs(kind):
    """lr of each of 22 updates under teochat_tpu's make_optimizer: the update
    of a unit Adam step (sign of a constant gradient) with b1 = b2 = 0."""
    opt = jax_trainer.make_optimizer(3e-4, total_steps=20, warmup_ratio=0.1,
                                     lr_scheduler_type=kind, max_grad_norm=None, b1=0.0,
                                     b2=0.0)
    p = {"w": jnp.zeros(())}
    state = opt.init(p)
    out = []
    for _ in range(22):
        u, state = opt.update({"w": jnp.ones(())}, state, p)
        out.append(-float(u["w"]) * (1 + 1e-8))  # undo eps: m / (sqrt(v) + eps), m = v = 1
    return out


def test_preprocess_dataset_and_collator_match_jax():
    data = [_raw_example(2, s) for s in range(3)] + [_raw_example(3, 9)]
    data.append({"conversations": [{"from": "human", "value": "What is a satellite?"},
                                   {"from": "gpt", "value": "A machine in orbit."}]})
    outs = []
    for mod in (jax_data, torch_data):
        tok = MockTokenizer()
        mod.set_default_conversation("v1")
        args = mod.DataArguments(image_processor=TinyProcessor())
        ds = mod.LazySupervisedDataset(tok, args, dataset=data)
        items = [ds[i] for i in range(len(ds))]
        coll = mod.TEOChatCollator(tok, tokens_per_frame=4, seq_buckets=(64, 128))
        outs.append((items, coll(items[:3]), coll(items[3:]), ds.modality_lengths))
    (ji, jb1, jb2, jlen), (ti, tb1, tb2, tlen) = outs
    assert jlen == tlen
    for j, t in zip(ji, ti):
        assert j["input_ids"] == t["input_ids"] and j["labels"] == t["labels"]
        assert len(j.get("image", [])) == len(t.get("image", []))
        for a, b in zip(j.get("image", []), t.get("image", [])):
            np.testing.assert_array_equal(a, b)
    for (jplan, jpix), (tplan, tpix) in ((jb1, tb1), (jb2, tb2)):
        np.testing.assert_array_equal(tpix, jpix)
        for field in dataclasses.fields(jplan):
            w, g = np.asarray(getattr(jplan, field.name)), getattr(tplan, field.name)
            assert g.dtype == w.dtype, field.name
            np.testing.assert_array_equal(g, w, err_msg=field.name)


def test_tiny_train_end_to_end_matches_jax(tmp_path, capsys, monkeypatch):
    from teochat_tpu.train import train as jax_train_mod
    from teochat_torch.train import train as torch_train_mod

    cfg = tiny_test_config(vocab_size=256)  # room for the mock tokenizer's words
    params = jax_teochat.init_teochat(jax.random.PRNGKey(12), cfg)
    data = [_raw_example(2, s) for s in range(8)]
    common = dict(per_device_train_batch_size=2, gradient_accumulation_steps=2,
                  learning_rate=1e-3, mm_projector_lr=2e-3, logging_steps=1, bf16=False,
                  lora_r=4, lora_alpha=8.0, seed=3)
    steps = 2

    jargs = jax_train_mod.TrainingArguments(output_dir=str(tmp_path), report_to="none",
                                            save_strategy="no", **common)
    capsys.readouterr()
    jstate = jax_train_mod.train(
        jax_train_mod.ModelArguments(), jax_data.DataArguments(image_processor=TinyProcessor()),
        jargs, cfg=cfg, params=params, tokenizer=MockTokenizer(), dataset=data,
        max_steps_override=steps)
    printed = re.findall(r"step \d+/\d+ loss ([0-9.]+)", capsys.readouterr().out)
    jlosses = [float(x) for x in printed]

    # the same initial adapters as the JAX driver's (its jax.random draw)
    jax_adapters = jax_lora.add_lora_params(jax.random.PRNGKey(3), params["llm"], rank=4,
                                            alpha=8.0)
    monkeypatch.setattr(torch_train_mod, "add_lora_params",
                        lambda gen, llm, rank, alpha: to_torch(_np(jax_adapters), "cpu"))
    history = []
    tstate = torch_train_mod.train(
        torch_train_mod.ModelArguments(),
        torch_data.DataArguments(image_processor=TinyProcessor()),
        torch_train_mod.TrainingArguments(output_dir=str(tmp_path / "torch"), report_to="none",
                                          save_strategy="no", **common),
        cfg=cfg, params=to_torch(_np(params), "cpu"),
        tokenizer=MockTokenizer(), dataset=data, max_steps_override=steps, history=history)

    assert len(jlosses) == len(history) == steps
    np.testing.assert_allclose([h["loss"] for h in history], jlosses, rtol=0, atol=5e-5 + 1e-6)
    assert all(h["tokens"] > 0 and h["padded_tokens"] >= h["tokens"] for h in history)
    # with B = 0 at the start and lr 0 at the first update, A has no gradient
    # yet at the second: B and the projector move
    before = {**_np(params), "llm": _np(jax_adapters)}
    _assert_same_updates(tstate.params, jstate.params, before, all_moved=False)
    assert np.abs(to_numpy(tstate.params)["llm"]["layers"]["mlp"]["down"]["lora_b"]).max() > 0


def test_train_keeps_fp32_masters_of_a_bf16_model(tiny, tmp_path):
    """train() on a bf16 tree: the adapters and the projector train as fp32
    copies (a bf16 weight would round the projector's small Adam steps away),
    the frozen leaves are shared and the caller's tree is not written."""
    from teochat_torch.train import train as torch_train_mod

    cfg, params = tiny
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, vocab_size=256))
    params = to_torch(_np(jax_teochat.init_teochat(jax.random.PRNGKey(13), cfg)), "cpu",
                      dtype=torch.bfloat16)
    before = {p: x.clone() for p, x in torch_trainer.tree_leaves_with_path(params)}
    args = torch_train_mod.TrainingArguments(
        per_device_train_batch_size=2, learning_rate=1e-3, mm_projector_lr=1e-5,
        lr_scheduler_type="constant", lora_r=4, lora_alpha=8.0, logging_steps=1, seed=3,
        output_dir=str(tmp_path), report_to="none")
    state = torch_train_mod.train(
        torch_train_mod.ModelArguments(),
        torch_data.DataArguments(image_processor=TinyProcessor()), args, cfg=cfg,
        params=params, tokenizer=MockTokenizer(),
        dataset=[_raw_example(2, s) for s in range(2)], max_steps_override=1)
    got = dict(torch_trainer.tree_leaves_with_path(state.params))
    for path, x in torch_trainer.tree_leaves_with_path(params):
        assert torch.equal(x, before[path]) and x.dtype == before[path].dtype, path
        if not jax_lora.lora_trainable_filter(path):
            assert got[path] is x, path
    trained = {p: x for p, x in got.items() if jax_lora.lora_trainable_filter(p)}
    assert len(trained) == 2 * 7 + 4
    assert all(x.dtype == torch.float32 for x in trained.values())
    kernels = [p for p in trained if p.startswith("projector/") and p.endswith("kernel")]
    assert len(kernels) == 2
    for path in kernels:
        x, old = trained[path], before[path]
        # the fp32 masters moved; rounded to bf16, most would be the old weights
        assert (x != old.float()).float().mean() > 0.9, path
        assert (x.to(torch.bfloat16) == old).float().mean() > 0.5, path


def test_train_refuses_what_is_not_ported(tiny, tmp_path):
    """What a run on one process cannot do raises: the mesh's sequence and
    pipeline axes are ported (tests/test_torch_parallel_train.py), and on
    one process an axis above 1 raises a ValueError naming its flag, as
    JAX's driver does on one device. The vision tokenizer is
    ported (tests/test_torch_vision_tokenizer.py trains with it): a
    projector-only run with mm_use_im_start_end trains the input embeddings
    and not the lm_head, as JAX's. MPT training is ported
    (tests/test_torch_mpt_train.py); the vision tokenizer takes no MPT
    decoder, as in JAX's driver, and an MPT run with a tokenizer that can
    grow raises a ValueError naming it before anything is saved."""
    from teochat_torch.checkpoint.bridge import init_mpt
    from teochat_torch.config import MeshConfig, MptConfig
    from teochat_torch.train import train as torch_train_mod

    cfg, params = tiny

    def run(model_kw=None, cfg=cfg, tokenizer=MockTokenizer, tparams=None, **train_kw):
        torch_train_mod.train(
            torch_train_mod.ModelArguments(**(model_kw or {})), torch_data.DataArguments(),
            torch_train_mod.TrainingArguments(output_dir=str(tmp_path), **train_kw),
            cfg=cfg, params=tparams or to_torch(_np(params), "cpu"), tokenizer=tokenizer())

    for flag, mesh in (("--mesh_sequence", MeshConfig(sequence=2)),
                       ("--mesh_pipe", MeshConfig(pipe=2))):
        with pytest.raises(ValueError, match=f"{flag} 2 needs a multi-device runtime"):
            run(mesh=mesh)
    # the mesh is ported (tests/test_torch_parallel_train.py); on one
    # process an axis above 1 has no ranks to split, and says so
    for mesh in (MeshConfig(fsdp=2), MeshConfig(data=2, fsdp=-1)):
        with pytest.raises(ValueError, match="processes"):
            run(mesh=mesh)
    from teochat_tpu.vision_tokenizer import embed_trainable_filter as jax_embed_filter

    args = torch_train_mod.ModelArguments(tune_mm_mlp_adapter=True, mm_use_im_start_end=True)
    keep = torch_train_mod.trainable_filter_of(
        args, torch_train_mod.TrainingArguments(output_dir=str(tmp_path), lora_enable=False))
    want = jax_embed_filter(lambda p: "projector" in p)
    for path in ("llm/embed_tokens/embedding", "llm/lm_head/kernel", "projector/layers/0/kernel",
                 "vision/layers/attn/q/kernel", "llm/layers/attn/q/kernel"):
        assert keep(path) == want(path), path
    assert keep("llm/embed_tokens/embedding") and not keep("llm/lm_head/kernel")
    class GrowingTokenizer(MockTokenizer):
        def add_tokens(self, tokens, special_tokens=False):
            return len(tokens)

    mpt_llm = MptConfig(vocab_size=128, d_model=32, n_layers=1, n_heads=2, expansion_ratio=2)
    mpt = dataclasses.replace(cfg, llm=mpt_llm, llm_backend="mpt")
    mpt_params = {**to_torch(_np(params), "cpu"),
                  "llm": init_mpt(mpt_llm, torch.Generator().manual_seed(0), "cpu", torch.float32)}
    with pytest.raises(ValueError, match="vision tokenizer"):
        run(cfg=mpt, tokenizer=GrowingTokenizer, tparams=mpt_params)
    assert not list(tmp_path.iterdir())  # nothing was saved


def test_train_modules_import_without_jax():
    import subprocess

    code = ("import sys\nsys.modules['jax'] = None\nsys.modules['optax'] = None\n"
            "import teochat_torch.train.train, teochat_torch.data.dataset\n"
            "assert not [n for n in sys.modules if n.startswith(('jax.', 'optax.'))]\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_bridge_keeps_lora_leaves_fp32():
    """A bf16 cast of the backbone leaves the LoRA masters fp32, both ways."""
    rs = np.random.RandomState(8)
    tree = {"q": {"kernel": rs.randn(2, 4, 6).astype(np.float32),
                  "lora_a": rs.randn(2, 4, 3).astype(np.float32),
                  "lora_b": rs.randn(2, 3, 6).astype(np.float32),
                  "lora_scale": np.full((2,), 2.0, np.float32)}}
    t = to_torch(tree, "cpu", dtype=torch.bfloat16)["q"]
    assert t["kernel"].dtype == torch.bfloat16
    assert all(t[n].dtype == torch.float32 for n in ("lora_a", "lora_b", "lora_scale"))
    back = to_numpy({"q": t})["q"]
    for n in ("lora_a", "lora_b", "lora_scale"):
        np.testing.assert_array_equal(back[n], tree["q"][n])
