"""The port's fusion, stopping and TEOChat shell against the JAX package.

Host builders must match array for array; greedy generation must give the
same tokens on a tiny fp32 model whose top logits are well separated (the
lm_head is scaled up, so reduction-order noise cannot flip an argmax); the
unmodified `run_inference_single` must return the same string on both
backends. A subprocess checks that the port and the chip smoke script import
with jax and triton blocked.
"""

import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from teochat_tpu.config import GenerationConfig, tiny_test_config
from teochat_tpu.constants import IMAGE_TOKEN_INDEX as IMG
from teochat_tpu.eval.inference import run_inference_single
from teochat_tpu.models import fusion as jax_fusion
from teochat_tpu.models import generation as jax_gen
from teochat_tpu.models import teochat as jax_teochat
from teochat_tpu.ops import quant as jax_quant
from teochat_torch.checkpoint.bridge import init_teochat as torch_init_teochat
from teochat_torch.checkpoint.bridge import to_numpy, to_torch
from teochat_torch.eval.inference import run_inference_single as torch_run_inference_single
from teochat_torch.models import fusion as torch_fusion
from teochat_torch.models import generation as torch_gen
from teochat_torch.models import teochat as torch_teochat
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GREEDY = GenerationConfig(max_new_tokens=8, temperature=0.0, do_sample=False, stop_strings=())


class WordTokenizer:
    """Word-level stand-in for the LLaMA tokenizer (ids grow as words appear)."""

    bos_token_id = 1
    eos_token_id = 2

    def __init__(self):
        self.vocab = {"<s>": 1, "</s>": 2}
        self.rev = {1: "<s>", 2: "</s>"}

    def __call__(self, text):
        ids = [1]
        for w in text.replace("</s>", " </s> ").split():
            if w not in self.vocab:
                self.vocab[w] = len(self.vocab) + 10
                self.rev[self.vocab[w]] = w
            ids.append(self.vocab[w])
        return types.SimpleNamespace(input_ids=ids)

    def decode(self, ids):
        return " ".join(self.rev.get(int(i), f"<{int(i)}>") for i in ids)


class FrameProcessor:
    """Returns seeded normalised frames for any list of paths (no image decode)."""

    def __init__(self, size):
        self.size = size

    def preprocess(self, paths):
        rs = np.random.RandomState(len(paths))
        return {"pixel_values": rs.randn(len(paths), 3, self.size, self.size).astype(np.float32)}


@pytest.fixture(scope="module")
def models():
    cfg = dataclasses.replace(tiny_test_config(vocab_size=128), dtype="float32")
    params = jax_teochat.init_teochat(jax.random.PRNGKey(7), cfg)
    llm = dict(params["llm"])
    llm["lm_head"] = {"kernel": llm["lm_head"]["kernel"] * 40.0}  # well-separated argmax
    params = {**params, "llm": llm}
    tparams = to_torch(jax.tree.map(np.asarray, params), "cpu")
    return jax_teochat.TEOChat(cfg, params), torch_teochat.TEOChat(cfg, tparams)


PLAN_CASES = [
    dict(input_ids=[[1, 5, IMG, 7, IMG, 9], [1, 3, 4]], tokens_per_frame=4, pad_to=16),
    dict(input_ids=[[1, IMG, 2], [IMG, IMG]], tokens_per_frame=3, max_length=5),
    dict(input_ids=[[1, 2, 3]], labels=[[-100, 5, 6]], tokens_per_frame=2),
]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_fusion_plan_matches_jax(case):
    want = jax_fusion.build_fusion_plan(**case)
    got = torch_fusion.build_fusion_plan(**case)
    for field in dataclasses.fields(want):
        w, g = np.asarray(getattr(want, field.name)), getattr(got, field.name)
        assert g.dtype == w.dtype, field.name
        np.testing.assert_array_equal(g, w, err_msg=field.name)


def test_stop_spec_matches_jax():
    tok = WordTokenizer()
    for strings in (("</s>",), ("###", "the end now"), ()):
        want = jax_gen.make_stop_spec(strings, tok, 2)
        got = torch_gen.make_stop_spec(strings, tok, 2)
        np.testing.assert_array_equal(got.keyword_ids, np.asarray(want.keyword_ids))
        np.testing.assert_array_equal(got.keyword_lens, np.asarray(want.keyword_lens))
        assert got.keyword_ids.dtype == np.asarray(want.keyword_ids).dtype
        assert got.eos_id == int(want.eos_id)


def test_greedy_generate_matches_jax(models):
    jm, tm = models
    ids = [[1, 5, IMG, 7, 8, IMG, 9], [1, 3, 4], [1, IMG, 6]]
    frames = np.random.RandomState(8).randn(3, 3, 28, 28).astype(np.float32)
    want = jm.generate(ids, frames, GREEDY)
    assert tm.generate(ids, frames, GREEDY) == want
    assert all(len(r) == GREEDY.max_new_tokens for r in want)


def test_eos_and_keyword_stops_match_jax(models):
    jm, tm = models
    ids = [[1, 5, IMG, 7, 8, 9], [1, 3, 4, 10]]
    frames = np.random.RandomState(9).randn(1, 3, 28, 28).astype(np.float32)
    free = jm.generate(ids, frames, GREEDY)
    # row 0 stops on a two-token keyword taken from its own output, row 1 on
    # EOS set to its third token
    kw = free[0][2:4]
    eos = free[1][2]
    mat, lens = np.array([kw], np.int32), np.array([2], np.int32)
    want = jm.generate(ids, frames, GREEDY, stop_spec=jax_gen.StopSpec(
        keyword_ids=jnp.asarray(mat), keyword_lens=jnp.asarray(lens),
        eos_id=jnp.asarray(eos, jnp.int32)))
    got = tm.generate(ids, frames, GREEDY, stop_spec=torch_gen.StopSpec(
        keyword_ids=mat, keyword_lens=lens, eos_id=eos))
    assert got == want
    assert got[0][-2:] == kw and len(got[0]) <= 4
    assert got[1][-1] == eos and len(got[1]) <= 3


def test_run_inference_single_same_string(models):
    jm, tm = models
    tok = WordTokenizer()
    proc = FrameProcessor(jm.cfg.vision.image_size)
    kwargs = dict(
        inp="These are images taken at different times: <video> Were any buildings damaged?",
        image_paths=["a.png", "b.png"], timestamps=["2020-02-01", "2020-01-01"],
        temperature=0.0, max_new_tokens=6,
    )
    want = run_inference_single(jm, proc, tok, **kwargs)
    got = torch_run_inference_single(tm, proc, tok, **kwargs)
    assert got == want and got


@pytest.mark.parametrize("quant", [None, "int8"])
def test_init_teochat_has_the_jax_layout_and_generates(quant):
    """The port's random init (what the card's main path runs) builds the
    JAX package's params tree, leaf for leaf in shape and dtype."""
    cfg = dataclasses.replace(tiny_test_config(vocab_size=64), dtype="float32")
    gen = torch.Generator().manual_seed(0)
    tparams = torch_init_teochat(cfg, gen, "cpu", torch.float32, quant=quant)
    jparams = jax_teochat.init_teochat(jax.random.PRNGKey(0), cfg)
    if quant == "int8":
        jparams = {**jparams, "llm": jax_quant.quantize_llama_params(jparams["llm"])}
    want, got = jax.tree.map(np.asarray, jparams), to_numpy(tparams)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert (g.shape, g.dtype) == (w.shape, w.dtype)
    frames = np.random.RandomState(10).randn(2, 3, 28, 28).astype(np.float32)
    out = torch_teochat.TEOChat(cfg, tparams).generate([[1, IMG, 5, IMG, 6], [1, 7]], frames, GREEDY)
    assert [len(r) for r in out] == [GREEDY.max_new_tokens] * 2
    assert all(0 <= t < cfg.llm.vocab_size for r in out for t in r)


def test_port_imports_without_jax_or_triton():
    """Nor with the JAX package: every module of the port, the smoke and the probe."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['triton'] = None\n"
        "sys.modules['teochat_tpu'] = None\n"
        "import teochat_torch\n"
        "for m in pkgutil.walk_packages(teochat_torch.__path__, 'teochat_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, chip_probe\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.startswith(('jax.', 'triton.', 'jaxlib', 'teochat_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO + os.pathsep + os.environ.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
