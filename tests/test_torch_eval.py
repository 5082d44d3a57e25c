"""The port's eval driver end to end against the JAX package's.

One tiny TEOChat checkpoint (tests/test_torch_builder.py's) goes through
each package's `eval()` on the same 2-example dataset of uint8 frames of
non-square sizes: each loads the checkpoint through its own `load_model`,
preprocesses the frames (the native path), generates greedily and writes its
result JSON. The JSON files and the metrics must be equal, a second call
must be answered from the JSON without a model, and unknown requests must
raise; a split is read through a stand-in `datasets`, and batch_size 2 runs
(tests/test_torch_eval_batched.py holds both to JAX's).
"""

import json
import sys
import types

import numpy as np
import pytest

from teochat_tpu import builder as jax_builder
from teochat_tpu.eval import eval as jax_eval
from teochat_torch import builder as torch_builder
from teochat_torch.eval import eval as torch_eval
from tests.test_torch_builder import _tiny_tower_config, tiny_state_dict, write_checkpoint


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = write_checkpoint(tmp_path_factory.mktemp("torch_eval") / "TEOChat-tiny",
                            tiny_state_dict(seed=5))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_builder, "load_config", _tiny_tower_config(jax_builder.load_config))
        mp.setattr(torch_builder, "load_config", _tiny_tower_config(torch_builder.load_config))
        yield path


def _dataset(ground_truths):
    rs = np.random.RandomState(11)
    sizes = [(40, 52, 3), (61, 37, 3), (28, 30, 3)]
    return [{
        "conversations": [
            {"value": "These are images taken at different times: <video> w7 w8 w9 w10?"},
            {"value": truth},
        ],
        "video": [rs.randint(0, 256, sizes[(i + j) % 3], dtype=np.uint8) for j in range(2)],
        "timestamp": ["2020-01-02", "2020-01-01"],
        "task": task,
    } for i, (task, truth) in enumerate(ground_truths)]


def _run(mod, ckpt, out_dir, dataset, **kwargs):
    kw = {"device": "cpu"} if mod is torch_eval else {}
    return mod.eval("fmow_high_res", model_path=ckpt, out_dir=str(out_dir), dataset=dataset,
                    temperature=0.0, max_new_tokens=5, **kw, **kwargs)


def _saved(out_dir):
    files = list((out_dir / "fmow_high_res").glob("*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        return files[0].name, json.load(f)


def test_eval_matches_jax_and_hits_the_cache(ckpt, tmp_path):
    # a first JAX run finds what the model answers; the dataset then names
    # one answer as the truth, so the metrics hold a task's accuracy
    probe = tmp_path / "probe"
    _run(jax_eval, ckpt, probe, _dataset([("a", "x"), ("b", "y")]))
    answer = _saved(probe)[1][0]["response"]
    assert answer
    dataset = _dataset([("fmow", answer), ("land_use", "residential")])
    want = _run(jax_eval, ckpt, tmp_path / "jax", dataset)
    got = _run(torch_eval, ckpt, tmp_path / "torch", dataset)
    assert got == want == {"fmow_accuracy": 1.0}
    assert _saved(tmp_path / "torch") == _saved(tmp_path / "jax")
    assert _saved(tmp_path / "torch")[0] == \
        "TEOChat-tiny_prompt_strategy_interleave_chronological_prefix_True.json"
    # the second call reads the JSON: no dataset, no model
    assert torch_eval.eval("fmow_high_res", model_path=ckpt, out_dir=str(tmp_path / "torch"),
                           dataset=None, model_bundle=None) == got


def test_eval_with_a_model_bundle_and_the_unported_requests(ckpt, tmp_path):
    bundle = torch_eval.load_model(ckpt, device="cpu")
    tokenizer, model, processor = bundle
    assert processor.size == 28 and model.device.type == "cpu"
    dataset = _dataset([("fmow", "x")])
    metrics = torch_eval.eval("fmow_high_res", model_path="some/TEOChat-tiny",
                              out_dir=str(tmp_path), dataset=dataset, model_bundle=bundle,
                              temperature=0.0, max_new_tokens=3)
    assert metrics == {}  # no task with a true positive, as in the reference
    assert _saved(tmp_path)[0].startswith("TEOChat-tiny_")
    with pytest.raises(ValueError, match="Unsupported dataset"):
        torch_eval.eval("not_a_dataset", model_path="x", out_dir=str(tmp_path))
    with pytest.raises(ValueError, match="Unsupported dataset"):
        torch_eval.main(["--dataset_name", "not_a_dataset", "--model_path", "x",
                         "--out_dir", str(tmp_path)])
    # no dataset: the split is read through `datasets` (a stand-in here)
    seen = []
    stand_in = types.ModuleType("datasets")
    stand_in.load_dataset = lambda *a, **k: seen.append((a, k)) or dataset
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "datasets", stand_in)
        torch_eval.eval("aid", model_path=ckpt, out_dir=str(tmp_path), model_bundle=bundle,
                        temperature=0.0, max_new_tokens=3)
    assert seen == [(("jirvin16/TEOChatlas",), {"split": "eval_AID", "cache_dir": None,
                                                 "trust_remote_code": True})]
    # batch_size > 1 runs the batched loop
    torch_eval.eval("ucm", model_path=ckpt, out_dir=str(tmp_path), dataset=dataset * 3,
                    model_bundle=bundle, batch_size=2, temperature=0.0, max_new_tokens=3)
    with open(next((tmp_path / "ucm").glob("*.json"))) as f:
        assert len(json.load(f)) == 3
    assert torch_eval.DATASET_NAME_TO_HF_SPLIT == jax_eval.DATASET_NAME_TO_HF_SPLIT
    assert torch_eval.CLASSIFICATION_DATASETS == jax_eval.CLASSIFICATION_DATASETS
    assert torch_eval.DETECTION_DATASETS == jax_eval.DETECTION_DATASETS
