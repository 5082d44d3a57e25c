"""The port's vision tokenizer (teochat_torch/vision_tokenizer.py) and its
callers against the JAX package, on the CPU.

Token adds and the `<im_start><image><im_end>` wrap are held to JAX's
exactly, through `_build_prompt` of eval/inference.py and the training
data's `preprocess_multimodal`. `resize_token_embeddings` is held leaf for
leaf on fp, int8 and int4 (flat `packed` and `packed_tiles`) lm_heads,
growing, shrinking and tied: the old rows and columns equal, the new ones
fp32 means that XLA and torch sum in other orders, so within a few fp32
ulps of the largest |value| summed (MEAN_ATOL), and a new column's
quantized byte may sit one step off where it lies on a rounding edge.
`initialize_vision_tokenizer` with a pretrained adapter's rows, and two
optimizer steps of the projector-only recipe with `mm_use_im_start_end`
(the embeddings training beside the projector), whose losses match JAX's
`train()` to its printed 4 decimals.
"""

import re
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from teochat_tpu import vision_tokenizer as jax_vt
from teochat_tpu.config import LlamaConfig, TEOChatConfig, tiny_test_config
from teochat_tpu.data import dataset as jax_data
from teochat_tpu.eval import inference as jax_inference
from teochat_tpu.models import teochat as jax_teochat
from teochat_tpu.ops import quant as jax_quant
from teochat_torch import vision_tokenizer as torch_vt
from teochat_torch.checkpoint.bridge import to_numpy, to_torch
from teochat_torch.data import dataset as torch_data
from teochat_torch.eval import inference as torch_inference
from teochat_torch.train import trainer as torch_trainer
from tests.test_data_pipeline import MockTokenizer, TinyProcessor, _raw_example
from tests.test_vision_tokenizer import GrowableMockTokenizer
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

MEAN_ATOL = 8 * 2.0 ** -23  # of the largest |value| a mean sums


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_wrap_and_token_adds_match_jax():
    text = "Image 1: <image>Image 2: <image> what changed?"
    assert torch_vt.wrap_image_tokens(text) == jax_vt.wrap_image_tokens(text)
    for flags in ((True, True), (True, False), (False, True), (False, False)):
        tj, tt = GrowableMockTokenizer(), GrowableMockTokenizer()
        assert torch_vt.add_vision_tokens(tt, *flags) == jax_vt.add_vision_tokens(tj, *flags)
        assert tt.vocab == tj.vocab and len(tt) == len(tj)
        assert torch_vt.add_vision_tokens(tt, *flags) == 0  # a second add is a no-op


def test_prompt_and_training_text_wrap_as_jax():
    """eval's prompt and the training data's human turn, with the flag."""
    args = ("These are images taken at different times: <video> What changed?",
            ["b.png", "a.png"], "v1", ["2020-03-01", "2020-01-01"], "interleave", True)
    want = jax_inference._build_prompt(*args, mm_use_im_start_end=True)
    assert torch_inference._build_prompt(*args, mm_use_im_start_end=True) == want
    assert want[0].count("<im_start><image><im_end>") == 2
    src = [[{"from": "human", "value": "<video>\nWhat changed?"}]]
    got, ref = (mod.preprocess_multimodal(
        [[dict(s) for s in src[0]]],
        mod.DataArguments(mm_use_im_start_end=True, prompt_strategy="interleave"),
        num_video_images=2) for mod in (torch_data, jax_data))
    assert got == ref and "Image 1: <im_start><image><im_end>" in got[0][0]["value"]


def _llm(seed, vocab, d, head="fp", tie=False):
    rs = np.random.RandomState(seed)
    p = {"embed_tokens": {"embedding": jnp.asarray(rs.randn(vocab, d).astype(np.float32))}}
    if not tie:
        w = jnp.asarray(rs.randn(d, vocab).astype(np.float32) * 0.1)
        w = w.at[:, 3].set(0.0)  # a zero column: scale 1
        p["lm_head"] = {"fp": lambda: {"kernel": w}, "int8": lambda: jax_quant.quantize_kernel(w),
                        "int4": lambda: jax_quant.quantize_kernel_int4(w)}[head]()
    return p


def _assert_resized_like_jax(got, want, old_vocab):
    got, want = to_numpy(got), _np(want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for path, g in torch_trainer.tree_leaves_with_path(got):
        w = dict(torch_trainer.tree_leaves_with_path(want))[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if path.endswith("embedding"):
            np.testing.assert_array_equal(g[:old_vocab], w[:old_vocab])
            np.testing.assert_allclose(g, w, rtol=0, atol=MEAN_ATOL * np.abs(w).max())
        elif g.dtype == np.float32:  # an fp kernel or a scale: new columns a mean
            np.testing.assert_allclose(g, w, rtol=2 ** -22, atol=MEAN_ATOL * np.abs(w).max())
        else:  # quantized bytes: a new column's may sit one step off on a rounding edge
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1, path


@pytest.mark.parametrize("head,vocab,new", [
    ("fp", 40, 45), ("fp", 40, 33), ("tied", 40, 47), ("fp", 40, 40),
    ("int8", 40, 44), ("int8", 40, 36), ("int4", 256, 261), ("int4", 600, 605),
    ("int4", 600, 520)], ids=lambda v: str(v))
def test_resize_token_embeddings_matches_jax(head, vocab, new):
    """fp, int8 and int4 lm_heads (600 columns: `packed_tiles`; 256 and
    shrunk to 520: flat `packed`), grown and shrunk, and a tied embedding."""
    d = 16
    p = _llm(vocab + new, vocab, d, head="fp" if head == "tied" else head, tie=head == "tied")
    want = jax_vt.resize_token_embeddings(p, new)
    got = torch_vt.resize_token_embeddings(to_torch(_np(p), "cpu"), new)
    if new == vocab:
        assert got["embed_tokens"]["embedding"].shape[0] == vocab
    _assert_resized_like_jax(got, want, min(vocab, new))
    assert tuple(got["embed_tokens"]["embedding"].shape) == (new, d)
    if head != "tied":
        w = torch_vt._dequant_lm_head(got["lm_head"])
        assert w.shape[1] == new
        if new > vocab:  # the new columns are the mean of the old ones, requantized
            np.testing.assert_allclose(
                w[:, vocab:].numpy(),
                np.repeat(np.asarray(jax_vt._dequant_lm_head(p["lm_head"])).mean(1, keepdims=True),
                          new - vocab, 1), atol=0.1 if head == "int4" else 2e-3)


@pytest.mark.parametrize("rows", ["whole", "new only", "bad"])
def test_initialize_vision_tokenizer_matches_jax(rows):
    """Both flags over an int8 lm_head, with a pretrained adapter's embed
    rows (the grown table, or only its new rows; another shape raises)."""
    cfg = TEOChatConfig(llm=LlamaConfig(vocab_size=16, hidden_size=8, intermediate_size=16,
                                        num_layers=1, num_heads=2, num_kv_heads=2))
    params = {"llm": _llm(1, 16, 8, head="int8")}
    pre = np.random.RandomState(5).randn(19, 8).astype(np.float32)
    pre = {"whole": pre, "new only": pre[-2:], "bad": pre[:4]}[rows]
    args = types.SimpleNamespace(mm_use_im_patch_token=True, mm_use_im_start_end=True)
    if rows == "bad":
        with pytest.raises(ValueError, match="Unexpected embed_tokens shape"):
            torch_vt.initialize_vision_tokenizer(args, cfg, to_torch(_np(params), "cpu"),
                                                 GrowableMockTokenizer(), torch.from_numpy(pre))
        return
    jcfg, jparams, jn = jax_vt.initialize_vision_tokenizer(args, cfg, params,
                                                           GrowableMockTokenizer(), pre)
    tcfg, tparams, tn = torch_vt.initialize_vision_tokenizer(
        args, cfg, to_torch(_np(params), "cpu"), GrowableMockTokenizer(), torch.from_numpy(pre))
    assert tn == jn == 3 and tcfg == jcfg and tcfg.llm.vocab_size == 19
    _assert_resized_like_jax(tparams["llm"], jparams["llm"], 16)
    np.testing.assert_array_equal(tparams["llm"]["embed_tokens"]["embedding"][-2:].numpy(),
                                  pre[-2:])


def test_embed_trainable_filter_matches_jax():
    for base in (None, lambda p: "projector" in p):
        got, want = torch_vt.embed_trainable_filter(base), jax_vt.embed_trainable_filter(base)
        for path in ("llm/embed_tokens/embedding", "llm/lm_head/kernel",
                     "projector/layers/0/kernel", "vision/layers/ln1/scale"):
            assert got(path) == want(path), path


class GrowingTokenizer(MockTokenizer):
    """The data pipeline's mock tokenizer over a 256-id vocabulary that
    `add_tokens` grows, as an HF tokenizer's."""

    BASE = 256

    def __init__(self):
        super().__init__()
        self.added = {}

    def add_tokens(self, tokens, special_tokens=False):
        new = [t for t in tokens if t not in self.added]
        for t in new:
            self.added[t] = self.BASE + len(self.added)
        self.vocab.update(self.added)
        return len(new)

    def __len__(self):
        return self.BASE + len(self.added)


def test_projector_and_embeddings_train_with_im_start_end_as_jax(tmp_path, capsys):
    """Two optimizer steps of the projector-only recipe with both vision-token
    flags: the tokenizer grows by three, the embedding and the lm_head by
    their mean, the prompts carry the wrap, and the embedding trains beside
    the projector (the lm_head frozen). The losses match JAX's `train()`
    to its printed 4 decimals; both grow the same tree."""
    from teochat_tpu.train import train as jax_train_mod
    from teochat_torch.train import train as torch_train_mod

    cfg = tiny_test_config(vocab_size=256)
    params = jax_teochat.init_teochat(jax.random.PRNGKey(12), cfg)
    data = [_raw_example(2, s) for s in range(4)]
    common = dict(per_device_train_batch_size=2, learning_rate=1e-3, mm_projector_lr=2e-3,
                  logging_steps=1, bf16=False, lora_enable=False, seed=3, report_to="none",
                  save_strategy="no")
    model_kw = dict(tune_mm_mlp_adapter=True, mm_use_im_start_end=True,
                    mm_use_im_patch_token=True)
    capsys.readouterr()
    jstate = jax_train_mod.train(
        jax_train_mod.ModelArguments(**model_kw),
        jax_data.DataArguments(image_processor=TinyProcessor()),
        jax_train_mod.TrainingArguments(output_dir=str(tmp_path / "jax"), **common),
        cfg=cfg, params=params, tokenizer=GrowingTokenizer(), dataset=data, max_steps_override=2)
    jlosses = [float(x) for x in re.findall(r"step \d+/\d+ loss ([0-9.]+)",
                                            capsys.readouterr().out)]
    history = []
    tstate = torch_train_mod.train(
        torch_train_mod.ModelArguments(**model_kw),
        torch_data.DataArguments(image_processor=TinyProcessor()),
        torch_train_mod.TrainingArguments(output_dir=str(tmp_path / "torch"), **common),
        cfg=cfg, params=to_torch(_np(params), "cpu"), tokenizer=GrowingTokenizer(),
        dataset=data, max_steps_override=2, history=history)
    assert len(jlosses) == len(history) == 2
    np.testing.assert_allclose([h["loss"] for h in history], jlosses, rtol=0, atol=5e-5 + 1e-6)
    got, want = to_numpy(tstate.params)["llm"], _np(jstate.params)["llm"]
    emb0 = np.asarray(params["llm"]["embed_tokens"]["embedding"])
    assert got["embed_tokens"]["embedding"].shape == want["embed_tokens"]["embedding"].shape \
        == (259, cfg.llm.hidden_size)
    moved = got["embed_tokens"]["embedding"][:256] - emb0
    assert np.abs(moved).max() > 0  # the embedding trained
    np.testing.assert_allclose(got["embed_tokens"]["embedding"], want["embed_tokens"]["embedding"],
                               rtol=0, atol=5e-5)
    np.testing.assert_array_equal(got["lm_head"]["kernel"][:, :256],
                                  np.asarray(params["llm"]["lm_head"]["kernel"]))
