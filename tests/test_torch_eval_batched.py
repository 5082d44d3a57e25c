"""Batched evaluation, the read of a split and device preprocessing, against the JAX package.

On the tiny TEOChat checkpoint of tests/test_torch_builder.py (loaded by
each package's own `load_model`, as tests/test_torch_eval.py does):
- `run_inference_batched` at batch 2 and 3 over ragged examples (2 or 3
  uint8 frames of non-square sizes, questions of different lengths): the
  port's outputs are JAX's, in dataset order, and batch 1's;
- `eval(batch_size=2)` in both packages: the same result JSON and metrics;
- `eval()` with no dataset reads its split through a stand-in `datasets`
  module, called with JAX's arguments;
and `ops/preprocess.py::preprocess_frames` against JAX's on uint8 frames
that it downsamples (512 x 640), upsamples (100 x 120), leaves (224 x 224)
and takes in portrait (300 x 200): within PREPROCESS_TOL, the fp32 sums of
the two resize products taken in another order (the weights are JAX's
own, built in its fp32 arithmetic; read up to 1.2e-5 at these sizes).
"""

import json
import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from teochat_tpu.eval import eval as jax_eval
from teochat_tpu.eval import inference as jax_inference
from teochat_tpu.ops import preprocess as jax_preprocess
from teochat_torch.eval import eval as torch_eval
from teochat_torch.eval import inference as torch_inference
from teochat_torch.ops import preprocess as torch_preprocess
from tests.test_torch_eval import _dataset, _run, _saved, ckpt  # noqa: F401 (a fixture)
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

PREPROCESS_TOL = 5e-5  # after normalization (|x| up to ~2.1)
ARGS = dict(prompt_strategy="interleave", chronological_prefix=True, conv_mode="v1",
            temperature=0.0, max_new_tokens=4, progress=False)


@pytest.fixture(scope="module")
def bundles(ckpt):  # noqa: F811
    return torch_eval.load_model(ckpt, device="cpu"), jax_eval.load_model(ckpt)


def _ragged(n):
    """`n` examples of 2 or 3 frames of three sizes and questions of 1 to 5
    extra words: fused lengths differ, so sorting reorders them."""
    rs = np.random.RandomState(13)
    sizes = [(40, 52, 3), (61, 37, 3), (28, 30, 3)]
    out = []
    for i in range(n):
        frames = 2 + i % 2
        words = " ".join(f"w{7 + j}" for j in range(1 + (3 * i) % 5))
        out.append({
            "conversations": [
                {"value": f"These are images taken at different times: <video> {words}?"},
                {"value": "x"},
            ],
            "video": [rs.randint(0, 256, sizes[(i + j) % 3], dtype=np.uint8)
                      for j in range(frames)],
            "timestamp": [f"2020-01-0{frames - j}" for j in range(frames)],
            "task": "fmow",
        })
    return out


@pytest.mark.parametrize("batch_size", [2, 3])
def test_run_inference_batched_matches_jax(bundles, batch_size):
    (ttok, tmodel, tproc), (jtok, jmodel, jproc) = bundles
    dataset = _ragged(5)
    got = torch_inference.run_inference(dataset, tmodel, ttok, tproc, batch_size=batch_size,
                                        **ARGS)
    want = jax_inference.run_inference_batched(dataset, jmodel, jtok, jproc,
                                               batch_size=batch_size, **ARGS)
    assert got == want
    assert [o["response"] for o in got] == [o["response"] for o in torch_inference.run_inference(
        dataset, tmodel, ttok, tproc, batch_size=1, **ARGS)]
    assert all(o["response"] for o in got)


def test_eval_batch_2_matches_jax(ckpt, tmp_path):  # noqa: F811
    dataset = _dataset([("fmow", "x"), ("land_use", "y"), ("fmow", "z")])
    want = _run(jax_eval, ckpt, tmp_path / "jax", dataset, batch_size=2)
    got = _run(torch_eval, ckpt, tmp_path / "torch", dataset, batch_size=2)
    assert got == want
    assert _saved(tmp_path / "torch") == _saved(tmp_path / "jax")


def test_eval_reads_its_split_as_jax_does(bundles, tmp_path, monkeypatch):
    """No dataset and no cached JSON: both packages call
    `datasets.load_dataset` (a stand-in that records its arguments and
    returns an in-memory split) alike, and answer the split alike."""
    calls = []
    split = _ragged(2)
    stand_in = types.ModuleType("datasets")
    stand_in.load_dataset = lambda *a, **k: calls.append((a, k)) or split
    monkeypatch.setitem(sys.modules, "datasets", stand_in)
    out = {}
    for name, mod, bundle in (("torch", torch_eval, bundles[0]), ("jax", jax_eval, bundles[1])):
        out[name] = mod.eval("aid", model_path="some/TEOChat-tiny", out_dir=str(tmp_path / name),
                             model_bundle=bundle, data_cache_dir=str(tmp_path / "hub"),
                             temperature=0.0, max_new_tokens=3)
    assert len(calls) == 2 and calls[0] == calls[1]
    assert calls[0] == (("jirvin16/TEOChatlas",), {"split": "eval_AID",
                                                   "cache_dir": str(tmp_path / "hub"),
                                                   "trust_remote_code": True})
    assert out["torch"] == out["jax"]
    with open(next((tmp_path / "torch" / "aid").glob("*.json"))) as f, \
            open(next((tmp_path / "jax" / "aid").glob("*.json"))) as g:
        assert json.load(f) == json.load(g)


@pytest.mark.parametrize("hw", [(512, 640), (100, 120), (224, 224), (300, 200)])
def test_preprocess_frames_matches_jax(hw):
    frames = np.random.RandomState(hw[0]).randint(0, 256, (3, *hw, 3), dtype=np.uint8)
    want = np.asarray(jax_preprocess.preprocess_frames(jnp.asarray(frames)))
    got = torch_preprocess.preprocess_frames(torch.from_numpy(frames))
    assert got.dtype == torch.float32 and got.shape == want.shape == (3, 3, 224, 224)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PREPROCESS_TOL)
    # the resize's weights are JAX's, row for row
    from jax._src.image.scale import _fill_keys_cubic_kernel, compute_weight_mat

    for n in hw:
        new = torch_preprocess._resized_shape(*hw, 224)[hw.index(n)]
        jw = np.asarray(compute_weight_mat(n, new, new / n, 0.0, _fill_keys_cubic_kernel, True))
        np.testing.assert_allclose(torch_preprocess.resize_weights(n, new), jw.T, rtol=0,
                                   atol=1e-7)
