"""The port's train() against the JAX driver's on the CPU, in fp32: the
trainable sets, periodic saves, pruning and auto-resume.

Both drivers get the same weights (JAX init, carried over through the
bridge), the same adapters (LoRA B drawn nonzero, given to both drivers in
place of their own draws), the same seeded data and the same flags. Each
side's train step is wrapped to record every micro-batch's loss and input
ids. Tolerances, with their reasons (as in tests/test_torch_train.py):
- each micro-batch's loss: 1e-5 relative (three decoder layers and a
  vocab-wide log-softmax summed in another order);
- each trained leaf's change over the run: 5e-2 relative L2 (Adam moves an
  element by about lr whatever its gradient's size, and some gradients of
  the tiny model are below fp32 noise); every frozen leaf bitwise unchanged.
The checkpoints the port writes are held to JAX's by their directories
(which steps, which of them hold an optimizer state) and, after a resume,
by the losses and leaves above.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from teochat_tpu.config import tiny_test_config
from teochat_tpu.data import dataset as jax_data
from teochat_tpu.models import teochat as jax_teochat
from teochat_tpu.ops import quant as jax_quant
from teochat_tpu.train import lora as jax_lora
from teochat_tpu.train import train as jax_train_mod
from teochat_torch.checkpoint import orbax_io
from teochat_torch.checkpoint.bridge import to_numpy, to_torch
from teochat_torch.data import dataset as torch_data
from teochat_torch.train import train as torch_train_mod
from teochat_torch.utils import tree_leaves_with_path
from tests.test_data_pipeline import MockTokenizer, TinyProcessor, _raw_example
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

FAST = 1e-5
STEP_REL_L2 = 5e-2
COMMON = dict(per_device_train_batch_size=2, gradient_accumulation_steps=2,
              learning_rate=1e-3, mm_projector_lr=2e-3, logging_steps=1, bf16=False,
              lora_r=4, lora_alpha=8.0, seed=3, report_to="none")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_test_config(vocab_size=256)  # room for the mock tokenizer's words
    params = _np(jax_teochat.init_teochat(jax.random.PRNGKey(12), cfg))
    # samples of 2-4 frames: the micro-batches differ in length, so a
    # replayed batch is told from another by its ids
    data = [_raw_example(2 + s % 3, s) for s in range(12)]
    return cfg, params, data


def _adapters(llm, seed):
    """LoRA adapters over `llm` with B drawn nonzero (every adapter trains)."""
    out = _np(jax_lora.add_lora_params(jax.random.PRNGKey(seed), llm, rank=4, alpha=8.0))
    rs = np.random.RandomState(seed)
    for group in jax_lora.LORA_TARGET_GROUPS:
        for proj in out["layers"][group].values():
            proj["lora_b"] = (rs.randn(*proj["lora_b"].shape) * 0.05).astype(np.float32)
    return out


class Recorder:
    """Wraps a driver's make_train_step: every micro-batch's loss, and its
    identity (its rows' fused lengths and the sum of its frames' pixels)."""

    def __init__(self, mod, monkeypatch):
        self.losses, self.ids, self.states = [], [], []
        inner = mod.make_train_step

        def make(*args, **kwargs):
            step = inner(*args, **kwargs)

            def run(state, plan, pixels):
                state, loss = step(state, plan, pixels)
                self.losses.append(float(loss))
                self.ids.append((np.asarray(plan.seq_lens).tolist(),
                                 float(np.asarray(pixels, np.float64).sum())))
                if mod is jax_train_mod:  # the next call donates the state's buffers
                    self.states.append(jax.tree.map(np.array, state))
                return state, loss

            return run

        monkeypatch.setattr(mod, "make_train_step", make)


def _run_both(tiny, tmp_path, monkeypatch, name, *, adapters=None, model_kw=None, steps=3,
              **train_kw):
    """One train() of each driver from the same weights; returns
    ((jax state, jax recorder), (port state, port recorder), the initial
    numpy tree with the adapters in)."""
    cfg, params, data = tiny
    if adapters is not None:
        monkeypatch.setattr(jax_train_mod, "add_lora_params", lambda *a, **k: adapters)
        monkeypatch.setattr(torch_train_mod, "add_lora_params",
                            lambda *a, **k: to_torch(adapters, "cpu"))
    kw = {**COMMON, **train_kw}
    model_kw = model_kw or {}
    jrec, trec = Recorder(jax_train_mod, monkeypatch), Recorder(torch_train_mod, monkeypatch)
    jstate = jax_train_mod.train(
        jax_train_mod.ModelArguments(**model_kw),
        jax_data.DataArguments(image_processor=TinyProcessor()),
        jax_train_mod.TrainingArguments(output_dir=str(tmp_path / f"jax_{name}"), **kw),
        cfg=cfg, params=jax.tree.map(jnp.asarray, params), tokenizer=MockTokenizer(),
        dataset=data, max_steps_override=steps)
    tstate = torch_train_mod.train(
        torch_train_mod.ModelArguments(**model_kw),
        torch_data.DataArguments(image_processor=TinyProcessor()),
        torch_train_mod.TrainingArguments(output_dir=str(tmp_path / f"torch_{name}"), **kw),
        cfg=cfg, params=to_torch(params, "cpu"), tokenizer=MockTokenizer(), dataset=data,
        max_steps_override=steps)
    before = {**params, "llm": params["llm"] if adapters is None else adapters}
    return (jstate, jrec), (tstate, trec), before


def _assert_same_updates(got_params, want_params, before, trainable):
    """Frozen leaves unchanged on both sides; each trained leaf's change
    agrees to STEP_REL_L2 (a leaf no gradient reaches stays put on both
    sides), but the tower's key bias, whose exact gradient is zero (a bias
    added to every key leaves the softmax as it is): both drivers step it
    on rounding noise, so each change is held to Adam's bound, lr an
    update. Returns (trained leaves, leaves that moved)."""
    leaves = dict(tree_leaves_with_path(before))
    got = dict(tree_leaves_with_path(to_numpy(got_params)))
    want = dict(tree_leaves_with_path(_np(want_params)))
    assert sorted(got) == sorted(want) == sorted(leaves)
    n_trained = n_moved = 0
    for path, b in leaves.items():
        b = np.asarray(b)
        if not trainable(path):
            np.testing.assert_array_equal(got[path], b, err_msg=path)
            np.testing.assert_array_equal(want[path], b, err_msg=path)
            continue
        n_trained += 1
        dw, dg = want[path] - b, got[path] - b
        n_moved += bool(np.abs(dw).max() > 0)
        if path == ZERO_GRADIENT:
            assert max(np.abs(dw).max(), np.abs(dg).max()) <= 3 * COMMON["learning_rate"]
            continue
        assert np.linalg.norm(dg - dw) <= STEP_REL_L2 * np.linalg.norm(dw), path
    return n_trained, n_moved


def _lora_int8(params):
    return _adapters(_np(jax_quant.quantize_llama_params(params["llm"])), seed=4)


# the tower's layer past mm_vision_select_layer -2 and its post-layernorm
# (leaves of one layer are stacked with the used layers): no gradient
UNUSED_BY_THE_LOSS = ("vision/post_layernorm/scale", "vision/post_layernorm/bias")
ZERO_GRADIENT = "vision/layers/attn/k/bias"
# (name, ModelArguments, TrainingArguments, the trainable set, its leaf count)
SETS = {
    "lora-int8": ({}, dict(bits=8), jax_lora.lora_trainable_filter, 2 * 7 + 4),
    "projector-only": (dict(tune_mm_mlp_adapter=True), dict(lora_enable=False),
                       lambda p: "projector" in p, 4),
    "full": (dict(freeze_backbone=False), dict(lora_enable=False), lambda p: True, None),
}


@pytest.mark.parametrize("name", list(SETS))
def test_three_steps_of_each_trainable_set_match_jax(tiny, tmp_path, monkeypatch, name):
    """Three optimizer steps at accumulation 2 through each driver's
    train(): LoRA over an int8 backbone, the projector alone, and full
    fine-tuning of the fp32 model (every leaf, the tower too)."""
    model_kw, train_kw, trainable, n_leaves = SETS[name]
    adapters = _lora_int8(tiny[1]) if name == "lora-int8" else None
    (jstate, jrec), (tstate, trec), before = _run_both(
        tiny, tmp_path, monkeypatch, name, adapters=adapters, model_kw=model_kw, **train_kw)
    assert len(trec.losses) == len(jrec.losses) == 6 and trec.ids == jrec.ids
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=FAST)
    n, moved = _assert_same_updates(tstate.params, jstate.params, before, trainable)
    assert n == (n_leaves or len(tree_leaves_with_path(before)))
    assert moved == n - (name == "full") * len(UNUSED_BY_THE_LOSS), (n, moved)
    assert tstate.step == int(jstate.step) == 6
    # the trained leaves are fp32 masters, the frozen ones the caller's dtype
    for path, x in tree_leaves_with_path(tstate.params):
        if trainable(path):
            assert x.dtype == torch.float32, path


def _ckpt_dirs(path):
    return {n: os.path.isdir(os.path.join(path, n, "opt_state"))
            for n in sorted(os.listdir(path)) if n.startswith("checkpoint-")}


def test_save_prune_and_resume_match_jax(tiny, tmp_path, monkeypatch):
    """save_steps 1, save_total_limit 2 over 3 steps: both drivers keep
    checkpoint-2 and -3, and the final save replaces checkpoint-3 without
    its optimizer state (F7). With checkpoint-3 removed, both resume from
    checkpoint-2 to step 4; the resumed run starts the epoch's data order
    from its first batch again (F8) and the two drivers agree."""
    adapters = _lora_int8(tiny[1])
    (jstate, jrec), (tstate, trec), before = _run_both(
        tiny, tmp_path, monkeypatch, "resume", adapters=adapters, bits=8, save_steps=1,
        save_total_limit=2)
    jdir, tdir = tmp_path / "jax_resume", tmp_path / "torch_resume"
    assert _ckpt_dirs(jdir) == _ckpt_dirs(tdir) == {"checkpoint-2": True, "checkpoint-3": False}
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=FAST)

    # the port's checkpoint-2 holds the state its run had after step 2
    _, cfg2, opt2 = orbax_io.load_checkpoint(str(tdir / "checkpoint-2"), restore_opt=True)
    assert dataclasses.asdict(cfg2) == dataclasses.asdict(tiny[0])
    assert opt2["mini_step"] == 0 and opt2["inner"]["count"] == {"base": 2, "projector": 2}

    for d in (jdir, tdir):
        shutil.rmtree(d / "checkpoint-3")
    first_ids = (jrec.ids[:2], trec.ids[:2])
    # F9: the JAX driver cannot restore an optimizer state from Orbax (see
    # the next test), so its resume is handed the state its run held after
    # step 2, as a working restore of checkpoint-2 would give it
    at_step2 = jrec.states[3]

    def restore(path, restore_opt, params_template, opt_template):
        assert os.path.basename(path) == "checkpoint-2" and restore_opt
        return jax.tree.map(jnp.asarray, at_step2.params), None, \
            jax.tree.map(jnp.asarray, at_step2.opt_state)

    monkeypatch.setattr(jax_train_mod, "load_checkpoint", restore)
    (jstate, jrec), (tstate, trec), _ = _run_both(
        tiny, tmp_path, monkeypatch, "resume", adapters=adapters, bits=8,
        save_steps=1, save_total_limit=2, steps=4)
    # steps 3 and 4 from checkpoint-2, on the first four micro-batches of the epoch
    assert len(trec.losses) == len(jrec.losses) == 4
    assert trec.ids[:2] == jrec.ids[:2] == first_ids[0] == first_ids[1]
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=FAST)
    assert int(jstate.step) == 2 + 4 and tstate.step == 2 + 4
    _assert_same_updates(tstate.params, jstate.params, before, jax_lora.lora_trainable_filter)
    assert _ckpt_dirs(jdir) == _ckpt_dirs(tdir) == {"checkpoint-3": True, "checkpoint-4": False}


def test_resume_without_optimizer_state_starts_adam_afresh(tiny, tmp_path, monkeypatch):
    """F7's consequence: a resume from a final save (no opt_state) restores
    the params and starts the optimizer state anew, in both drivers."""
    adapters = _lora_int8(tiny[1])
    _run_both(tiny, tmp_path, monkeypatch, "fresh", adapters=adapters, bits=8,
              save_strategy="no", steps=2)
    assert _ckpt_dirs(tmp_path / "torch_fresh") == {"checkpoint-2": False}
    (jstate, jrec), (tstate, trec), _ = _run_both(
        tiny, tmp_path, monkeypatch, "fresh", adapters=adapters, bits=8,
        save_strategy="no", steps=3)
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=FAST)
    assert tstate.opt_state["inner"]["count"] == {"base": 1, "projector": 1}
    assert tstate.step == int(jstate.step) == 2 + 2


def test_jax_resume_from_a_periodic_checkpoint_raises_where_the_port_resumes(
        tiny, tmp_path, monkeypatch):
    """F9: the JAX driver cannot restore a checkpoint's optimizer state
    (its opt template is eval_shape's, which `orbax_io._abstract` cannot
    take), so a run stopped after a periodic save does not resume there;
    the port's does."""
    adapters = _lora_int8(tiny[1])
    _run_both(tiny, tmp_path, monkeypatch, "stopped", adapters=adapters, bits=8,
              save_steps=1, steps=2)
    for name in ("jax_stopped", "torch_stopped"):  # as if stopped before step 2's saves
        shutil.rmtree(tmp_path / name / "checkpoint-2")
        assert (tmp_path / name / "checkpoint-1" / "opt_state").is_dir()
    args = dict(output_dir=str(tmp_path / "jax_stopped"), **{**COMMON, "bits": 8})
    with pytest.raises(TypeError):
        jax_train_mod.train(
            jax_train_mod.ModelArguments(), jax_data.DataArguments(image_processor=TinyProcessor()),
            jax_train_mod.TrainingArguments(**args), cfg=tiny[0],
            params=jax.tree.map(jnp.asarray, tiny[1]), tokenizer=MockTokenizer(),
            dataset=tiny[2], max_steps_override=3)
    args["output_dir"] = str(tmp_path / "torch_stopped")
    history = []
    state = torch_train_mod.train(
        torch_train_mod.ModelArguments(), torch_data.DataArguments(image_processor=TinyProcessor()),
        torch_train_mod.TrainingArguments(**args), cfg=tiny[0], params=to_torch(tiny[1], "cpu"),
        tokenizer=MockTokenizer(), dataset=tiny[2], max_steps_override=3, history=history)
    assert [h["step"] for h in history] == [2, 3] and state.step == 1 + 4
    assert state.opt_state["inner"]["count"] == {"base": 3, "projector": 3}
