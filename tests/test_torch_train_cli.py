"""The port's training entry point against the JAX package's, on the CPU.

- the CLI: the port's parser gives the JAX CLI's dataclasses, field for
  field, for scripts/train_teochat.sh's flags, the reference's verbatim argv
  and the defaults; `python -m teochat_torch.train.cli` with JAX blocked
  trains a tiny checkpoint from a local dataset dir, saves, prunes and
  resumes;
- the train-time builder: `load_pretrained_model(allow_partial=True)` and
  `initialize_vision_modules` give JAX's config and trees, exactly, for a
  tower dir, a pretrained projector and a fresh draw (same shapes, dtypes
  and init scale: the draws come from different generators);
- the data templates llama_2, mpt and plain: JAX's input_ids and labels,
  exactly;
- `PrefetchLoader` (tests/test_loader.py's cases) and the prefetch thread;
- checkpoints: a save and a load are bitwise for int8, bf16 and fp32
  leaves (views and shared storage too) and for the optimizer state.
"""

import copy
import dataclasses
import json
import os
import re
import shlex
import shutil
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import jax

from teochat_tpu import builder as jax_builder
from teochat_tpu.data import dataset as jax_data
from teochat_tpu.train import cli as jax_cli
from teochat_torch import builder as torch_builder
from teochat_torch.checkpoint import orbax_io
from teochat_torch.data import dataset as torch_data
from teochat_torch.data.loader import PrefetchLoader
from teochat_torch.models import teochat as torch_teochat
from teochat_torch.train import cli as torch_cli
from teochat_torch.train import train as torch_train_mod
from teochat_torch.train import trainer as torch_trainer
from teochat_torch.utils import tree_leaves_with_path
from tests.test_data_pipeline import MockTokenizer, TinyProcessor
from tests.test_torch_builder import (
    D,
    TOWER,
    VOCAB,
    assert_trees_equal,
    hf_config,
    tiny_state_dict,
    write_checkpoint,
)
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_cli.py::test_train_cli_accepts_reference_script_verbatim's argv
REFERENCE_ARGV = (
    "--bits 8 --lora_enable True --lora_r 128 --lora_alpha 256 --mm_projector_lr 2e-5 "
    "--deepspeed ./scripts/zero3_offload.json --model_name_or_path LanguageBind/Video-LLaVA-7B "
    "--version v1 --data_name jirvin16/TEOChatlas --data_split train "
    "--image_tower LanguageBind/LanguageBind_Image --freeze_backbone True "
    "--freeze_mm_mlp_adapter False --mm_projector_type mlp2x_gelu "
    "--pretrain_mm_mlp_adapter /path/to/mm_projector.bin --mm_vision_select_layer -2 "
    "--mm_use_im_start_end False --mm_use_im_patch_token False --image_aspect_ratio square "
    "--group_by_modality_length True --bf16 True --output_dir /tmp/out --num_train_epochs 2 "
    "--per_device_train_batch_size 1 --per_device_eval_batch_size 1 --evaluation_strategy no "
    "--save_strategy steps --save_steps 2000 --save_total_limit 10 --learning_rate 2e-5 "
    "--weight_decay 0. --warmup_ratio 0.03 --lr_scheduler_type cosine --logging_steps 1 "
    "--tf32 True --model_max_length 2048 --tokenizer_model_max_length 3072 "
    "--gradient_checkpointing True --dataloader_num_workers 8 --video_as_image_list True "
    "--prompt_strategy interleave --chronological_prefix True --lazy_preprocess True "
    "--report_to wandb --cache_dir cache_dir"
).split()


def _script_argv():
    """scripts/train_teochat.sh's flags, its variables at their defaults."""
    with open(os.path.join(REPO, "scripts", "train_teochat.sh")) as f:
        body = f.read().split("python -m teochat_tpu.train.cli", 1)[1]
    body = re.sub(r'"\$\{\w+:-([^}]*)\}"', r"\1", body.replace('"$@"', ""))
    return shlex.split(body.replace("\\\n", " "))


ARGVS = {"script": _script_argv(), "reference": REFERENCE_ARGV,
         "defaults": ["--model_name_or_path", "x"]}


def _jax_dataclasses(argv, monkeypatch):
    got = []
    monkeypatch.setattr(jax_cli, "train", lambda *args: got.append(args))
    jax_cli.main(argv)
    return got[0]


@pytest.mark.parametrize("name", list(ARGVS))
def test_parser_gives_the_jax_cli_dataclasses(name, monkeypatch, capsys):
    argv = ARGVS[name]
    assert len(argv) > 1
    want = _jax_dataclasses(argv, monkeypatch)
    got = torch_cli.parse_args(argv)[:3]
    for w, g in zip(want, got):
        assert type(g).__name__ == type(w).__name__
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
    if name == "script":  # the recipe's own choices arrived
        assert got[2].bits == 8 and got[2].lora_enable and got[1].chronological_prefix
    capsys.readouterr()


def test_cli_refuses_distributed_and_ignores_deepspeed(monkeypatch, capsys):
    """--distributed is ported (test_cli_distributed_trains_on_two_ranks):
    outside torchrun's environment it refuses, naming what is missing,
    before anything loads. --deepspeed is accepted and ignored."""
    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        torch_cli.main(["--model_name_or_path", "x", "--distributed", "--device", "cpu"])
    seen = []
    monkeypatch.setattr(torch_cli, "train", lambda *a, **k: seen.append((a, k)) or "state")
    assert torch_cli.main(["--model_name_or_path", "x", "--deepspeed", "z.json",
                           "--device", "cpu"], history=[]) == "state"
    assert "--deepspeed z.json ignored" in capsys.readouterr().out
    assert seen[0][1] == {"history": [], "device": "cpu"}


# ------------------------------------------------------------- train-time builder

def _tower_dir(path, sd):
    """A LanguageBind_Image-style tower dir: vision_model.* keys and the
    tower's own config.json (the tiny geometry)."""
    os.makedirs(path, exist_ok=True)
    torch.save({k.split("image_tower.image_tower.")[1]: v for k, v in sd.items()
                if "image_tower" in k}, os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"hidden_size": TOWER["hidden_size"],
                   "intermediate_size": TOWER["intermediate_size"],
                   "num_hidden_layers": TOWER["num_layers"],
                   "num_attention_heads": TOWER["num_heads"],
                   "image_size": TOWER["image_size"], "patch_size": TOWER["patch_size"]}, f)
    return str(path)


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    """A plain LM dir (no tower, no projector), a tower dir and a
    pretrained projector file (reference --pretrain_mm_mlp_adapter)."""
    root = tmp_path_factory.mktemp("train_cli")
    sd = tiny_state_dict(seed=7)
    lm = {k: v for k, v in sd.items() if "mm_projector" not in k and "image_tower" not in k}
    config = hf_config()
    for k in ("mm_projector_type", "mm_hidden_size"):
        config.pop(k)
    adapter = str(root / "mm_projector.bin")
    torch.save({k: v for k, v in sd.items() if "mm_projector" in k}, adapter)
    return {"lm": write_checkpoint(root / "plain-lm", lm, n_shards=1, config=config),
            "tower": _tower_dir(root / "tower", sd), "adapter": adapter, "sd": sd,
            "root": root}


def _model_args(**over):
    base = dict(image_tower=None, video_tower=None, mm_projector_type="mlp2x_gelu",
                mm_vision_select_layer=-2, mm_vision_select_feature="patch",
                pretrain_mm_mlp_adapter=None)
    return types.SimpleNamespace(**{**base, **over})


def test_allow_partial_and_initialize_vision_modules_match_jax(parts):
    """The reference's train-time flow (train.py:961 + llava_arch.py:51):
    the plain LM loads without tower or projector, then both are attached
    from the tower dir and the pretrained projector file."""
    jtok, jm, _, _ = jax_builder.load_pretrained_model(parts["lm"], None, "plain-lm",
                                                       allow_partial=True)
    ttok, tm, tproc, _ = torch_builder.load_pretrained_model(parts["lm"], None, "plain-lm",
                                                             allow_partial=True, device="cpu")
    assert set(tm.params) == set(jm.params) == {"llm"} and len(ttok) == len(jtok) == VOCAB
    assert_trees_equal(tm.params, jm.params)
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    args = _model_args(image_tower=parts["tower"], pretrain_mm_mlp_adapter=parts["adapter"])
    jcfg, jparams = jax_builder.initialize_vision_modules(args, jm.cfg, jm.params)
    tcfg, tparams = torch_builder.initialize_vision_modules(args, tm.cfg, tm.params)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.vision.hidden_size == TOWER["hidden_size"] and tcfg.projector.mm_hidden_size == 32
    assert_trees_equal(tparams, jparams)
    assert tparams["llm"] is tm.params["llm"]
    want = parts["sd"]["model.mm_projector.0.weight"].T.to(torch.bfloat16)
    assert torch.equal(tparams["projector"]["layers"][0]["kernel"], want)
    # the attached model runs
    frames = np.random.RandomState(0).randn(1, 3, 28, 28).astype(np.float32)
    out = torch_teochat.TEOChat(tcfg, tparams, tokenizer=ttok).generate([[1, 5, -200, 9]], frames)
    assert len(out[0]) > 0


def test_initialize_vision_modules_fresh_projector_and_present_subtrees(parts):
    """No pretrained projector: a fresh draw of JAX's shapes, dtype and
    init scale (kernels N(0, 1 / fan_in), zero biases), the same draw from
    the same generator; subtrees already present are kept as they are; a
    missing tower that is not a local dir raises in both packages."""
    _, jm, _, _ = jax_builder.load_pretrained_model(parts["lm"], None, "plain-lm",
                                                    allow_partial=True)
    _, tm, _, _ = torch_builder.load_pretrained_model(parts["lm"], None, "plain-lm",
                                                      allow_partial=True, device="cpu")
    args = _model_args(image_tower=parts["tower"], mm_projector_type="linear",
                       mm_vision_select_layer=-1, mm_vision_select_feature="cls_patch")
    jcfg, jparams = jax_builder.initialize_vision_modules(args, jm.cfg, jm.params,
                                                          rng=jax.random.PRNGKey(1))
    draws = [torch_builder.initialize_vision_modules(
        args, tm.cfg, tm.params, generator=torch.Generator().manual_seed(1))
        for _ in range(2)]
    tcfg, tparams = draws[0]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.mm_vision_select_feature == "cls_patch" and tcfg.projector.projector_type == "linear"
    assert_trees_equal(tparams["vision"], jparams["vision"])
    (tk,), (jk,) = tparams["projector"]["layers"], jparams["projector"]["layers"]
    assert tk["kernel"].shape == jk["kernel"].shape == (32, D)
    assert tk["kernel"].dtype == torch.bfloat16 and jk["kernel"].dtype == jax.numpy.bfloat16
    assert not tk["bias"].any() and not np.asarray(jk["bias"], np.float32).any()
    for k in (tk["kernel"].float().numpy(), np.asarray(jk["kernel"], np.float32)):
        assert abs(k.std() * np.sqrt(32) - 1) < 0.1
    assert torch.equal(tk["kernel"], draws[1][1]["projector"]["layers"][0]["kernel"])

    cfg3, kept = torch_builder.initialize_vision_modules(args, tcfg, tparams)
    assert all(kept[k] is tparams[k] for k in tparams) and cfg3 == tcfg
    no_tower = _model_args(image_tower=str(parts["root"] / "missing"))
    with pytest.raises(FileNotFoundError):
        jax_builder.initialize_vision_modules(no_tower, jm.cfg, jm.params)
    with pytest.raises(FileNotFoundError):
        torch_builder.initialize_vision_modules(no_tower, tm.cfg, tm.params)


# ------------------------------------------------------------------ data templates

@pytest.fixture
def templates():
    yield
    for mod in (jax_data, torch_data):
        mod.set_default_conversation("v1")


def _sources(version):
    q = "<image>\nWhat changed between the images?"
    one = [{"from": "human", "value": q}, {"from": "gpt", "value": "A road was built."}]
    if version == "plain":
        return [one]
    two = one + [{"from": "human", "value": "Where is it?"},
                 {"from": "gpt", "value": "In the north."}]
    return [one, two]


@pytest.mark.parametrize("version", ["llama_2", "llava_llama_2", "mpt", "plain", "v1"])
def test_templates_give_jax_ids_and_labels(version, templates):
    outs = []
    for mod in (jax_data, torch_data):
        mod.set_default_conversation(version)
        direct = mod.preprocess(copy.deepcopy(_sources(version)), MockTokenizer(), has_image=True)
        # and through the dataset, frames and all
        rs = np.random.RandomState(3)
        data = [{"conversations": copy.deepcopy(s),
                 "image": rs.randint(0, 255, (30, 30, 3), np.uint8)} for s in _sources(version)]
        ds = mod.LazySupervisedDataset(MockTokenizer(),
                                       mod.DataArguments(image_processor=TinyProcessor()),
                                       dataset=data)
        outs.append((direct, [ds[i] for i in range(len(ds))]))
    (jd, ji), (td, ti) = outs
    assert td == jd and len(jd["input_ids"]) == len(_sources(version))
    for j, t in zip(ji, ti):
        assert t["input_ids"] == j["input_ids"] and t["labels"] == j["labels"]
    if version in ("plain", "v1"):  # answers kept, prompts masked
        assert all(-100 in lab and set(lab) != {-100} for lab in td["labels"])


# ----------------------------------------------------------------------- loading

class SlowDataset:
    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if self.fail_at is not None and i == self.fail_at:
            raise RuntimeError("boom")
        time.sleep(0.002)
        return i


LOADER_CASES = {  # tests/test_loader.py's four cases
    "order": (dict(n=23), dict(batch_size=4, num_workers=4), [list(range(i, i + 4))
                                                              for i in range(0, 20, 4)]),
    "keep last partial": (dict(n=10), dict(batch_size=4, drop_last=False),
                          [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]),
    "sampler order": (dict(n=8), dict(batch_size=2, sampler=[7, 6, 5, 4, 3, 2, 1, 0]),
                      [[7, 6], [5, 4], [3, 2], [1, 0]]),
    "error": (dict(n=8, fail_at=3), dict(batch_size=4, num_workers=2), RuntimeError),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_prefetch_loader_cases(case):
    ds_kw, kw, want = LOADER_CASES[case]
    loader = PrefetchLoader(SlowDataset(**ds_kw), collate=list, **kw)
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="boom"):
            list(loader)
        return
    assert list(loader) == want and len(loader) == len(want)


def test_prefetch_loader_stays_within_its_window_and_the_prefetch_thread_stops():
    """At most `prefetch` batches load ahead of the consumer (the JAX
    loader queues them all); the train driver's prefetch thread keeps the
    order, re-raises at the consumer and ends when the consumer stops."""
    loaded = []

    class Recording(SlowDataset):
        def __getitem__(self, i):
            loaded.append(i)
            return i

    it = iter(PrefetchLoader(Recording(40), collate=list, batch_size=2, num_workers=2,
                             prefetch=3))
    assert next(it) == [0, 1]
    time.sleep(0.2)
    assert len(loaded) <= 2 * (1 + 3 + 1)
    it.close()

    assert list(torch_train_mod._prefetch(iter(range(100)), depth=4)) == list(range(100))

    def bad():
        yield 1
        raise RuntimeError("boom")

    out = torch_train_mod._prefetch(bad(), depth=2)
    assert next(out) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(out)
    before = threading.active_count()
    out = torch_train_mod._prefetch(iter(range(10 ** 6)), depth=2)
    assert next(out) == 0
    out.close()
    for _ in range(50):
        if threading.active_count() < before + 1:
            break
        time.sleep(0.02)
    assert threading.active_count() <= before


# -------------------------------------------------------------------- checkpoints

def _equal_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    """int8 kernels with fp32 scales, bf16 and fp32 leaves, a view, a
    transposed view and a leaf that shares storage, the optimizer state of
    MultiSteps(AdamW) after two calls: each leaf written once, none
    dropped, and read back bit for bit; with a template, in its dtypes.
    A save without an optimizer state over the same step removes the old
    one (JAX's overwrite rule, the root of F7)."""
    g = torch.Generator().manual_seed(0)
    base = torch.randn(6, 8, generator=g)
    params = {
        "llm": {"q": {"kernel": torch.randint(-127, 128, (2, 8, 6), dtype=torch.int8, generator=g),
                      "scale": torch.rand(2, 6, generator=g),
                      "lora_a": torch.randn(2, 8, 4, generator=g),
                      "lora_scale": torch.tensor(2.0)},
                "embed": base.to(torch.bfloat16)},
        "projector": {"layers": [{"kernel": base, "bias": base[1]},
                                 {"kernel": base.t(), "bias": base[2:4].reshape(-1)}]},
    }
    opt = torch_trainer.MultiSteps(torch_trainer.make_optimizer(1e-3, projector_lr=1e-4,
                                                                total_steps=4), 2)
    trainable = lambda p: not p.endswith(("kernel", "scale", "embed")) or "projector" in p  # noqa: E731
    masters = torch_trainer.fp32_masters(params, trainable)
    state = torch_trainer.init_train_state(masters, opt, trainable)
    leaves = dict(torch_trainer._trainable_leaves(masters, trainable))
    for _ in range(2):
        opt.step(leaves, {p: torch.randn(x.shape, generator=g) for p, x in leaves.items()},
                 state.opt_state)
    path = orbax_io.save_checkpoint(str(tmp_path), masters, opt_state=state.opt_state, step=7)
    assert os.path.basename(path) == "checkpoint-7"
    from safetensors import safe_open

    for sub, tree in (("params", masters), ("opt_state", state.opt_state)):
        with safe_open(os.path.join(path, sub, orbax_io.TREE_FILE), "pt") as f:
            assert sorted(f.keys()) == sorted(p for p, x in tree_leaves_with_path(tree)
                                              if isinstance(x, torch.Tensor))
    got, cfg, got_opt = orbax_io.load_checkpoint(path, restore_opt=True)
    assert cfg is None and got_opt["mini_step"] == 0 and got_opt["inner"]["count"] == {
        "base": 1, "projector": 1}
    for tree, back in ((masters, got), (state.opt_state, got_opt)):
        want = dict(tree_leaves_with_path(tree))
        have = dict(tree_leaves_with_path(back))
        assert sorted(have) == sorted(want)
        for p, x in want.items():
            assert _equal_bits(have[p], x) if isinstance(x, torch.Tensor) else have[p] == x, p
    # with a template: the template's dtypes
    template = torch_trainer._tree_map_with_path(lambda p, x: x.to(torch.bfloat16)
                                                 if x.dtype == torch.float32 else x, masters)
    typed, _, _ = orbax_io.load_checkpoint(path, params_template=template)
    for p, x in tree_leaves_with_path(typed):
        assert x.dtype == dict(tree_leaves_with_path(template))[p].dtype, p
    with pytest.raises(ValueError, match="template"):
        orbax_io.load_checkpoint(path, params_template={"llm": {}})

    orbax_io.save_checkpoint(str(tmp_path), masters, step=7)
    assert not os.path.exists(os.path.join(path, "opt_state"))
    os.makedirs(tmp_path / "checkpoint-12x")
    orbax_io.save_checkpoint(str(tmp_path), {"x": torch.zeros(1)}, step=10)
    assert orbax_io.latest_checkpoint(str(tmp_path)).endswith("checkpoint-10")
    assert orbax_io.latest_checkpoint(str(tmp_path / "none")) is None


# --------------------------------------------------------------- the CLI, end to end

QUESTION = ("These are images taken at different times: <video> Which class does this "
            "sequence belong to ?")


def _word_tokenizer(path, texts):
    """A word-level tokenizer.json of VOCAB tokens holding every word of
    `texts` (the v1 template's system prompt and roles among them)."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    words = sorted(set(re.findall(r"\w+|[^\w\s]+", " ".join(texts))) - {"<", ">", "</"})
    vocab = {w: i for i, w in enumerate(["<unk>", "<s>", "</s>"] + words)}
    for i in range(len(vocab), VOCAB):
        vocab[f"w{i}"] = i
    tok = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<s>",
                   "eos_token": "</s>", "unk_token": "<unk>"}, f)


def _dataset_dir(path, n):
    """A local dataset dir as `datasets.load_dataset(dir, split="train")`
    reads it: train.parquet (JSON lines would have the timestamps parsed
    as dates) of 2-3 frame samples, the frames PNG files by absolute path."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from PIL import Image

    os.makedirs(path)
    rs = np.random.RandomState(5)
    rows = []
    for i in range(n):
        frames = []
        for j in range(2 + i % 2):
            f = os.path.join(path, f"s{i}_{j}.png")
            Image.fromarray(rs.randint(0, 255, (40, 48, 3), np.uint8)).save(f)
            frames.append(f)
        rows.append({"video": frames, "timestamp": [f"2020-0{j + 1}-15" for j in range(len(frames))],
                     "conversations": [{"from": "human", "value": QUESTION},
                                       {"from": "gpt", "value": ["airport", "dam", "factory"][i % 3]}]})
    pq.write_table(pa.Table.from_pylist(rows), os.path.join(path, "train.parquet"))
    return str(path)


def test_cli_trains_saves_prunes_and_resumes_without_jax(parts, tmp_path):
    """`python -m teochat_torch.train.cli` with the recipe's flags (LoRA over
    an int8 backbone, the tower from --image_tower, the projector from
    --pretrain_mm_mlp_adapter), JAX and optax blocked: 3 steps at
    accumulation 2 with a prefetch thread, a save every 2 steps pruned to
    1, the final save; then a second run resumes from the newest
    checkpoint to step 4."""
    from teochat_torch.conversation import conv_templates

    lm = str(tmp_path / "lm")
    shutil.copytree(parts["lm"], lm)
    v1 = conv_templates["v1"]
    _word_tokenizer(lm, [v1.system, *v1.roles, QUESTION, "Image 1 2 3 in chronological order",
                         "airport dam factory"])
    data = _dataset_dir(tmp_path / "data", 8)
    out = str(tmp_path / "out")
    argv = (f"--bits 8 --lora_enable True --lora_r 4 --lora_alpha 8 --mm_projector_lr 2e-5 "
            f"--deepspeed ./scripts/zero3_offload.json --model_name_or_path {lm} --version v1 "
            f"--data_name {data} --data_split train --data_cache_dir {tmp_path / 'cache'} "
            f"--image_tower {parts['tower']} --freeze_backbone True "
            f"--freeze_mm_mlp_adapter False --mm_projector_type mlp2x_gelu "
            f"--pretrain_mm_mlp_adapter {parts['adapter']} --mm_vision_select_layer -2 "
            f"--mm_use_im_start_end False --mm_use_im_patch_token False "
            f"--group_by_modality_length True --bf16 False --output_dir {out} "
            f"--num_train_epochs 2 --per_device_train_batch_size 2 "
            f"--gradient_accumulation_steps 2 --save_strategy steps --save_steps 2 "
            f"--save_total_limit 1 --learning_rate 1e-3 --weight_decay 0. --warmup_ratio 0.03 "
            f"--lr_scheduler_type cosine --logging_steps 1 --tf32 True --model_max_length 2048 "
            f"--tokenizer_model_max_length 3072 --gradient_checkpointing True "
            f"--dataloader_num_workers 2 --prompt_strategy interleave --chronological_prefix True "
            f"--lazy_preprocess True --report_to none --device cpu").split()
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\nsys.modules['optax'] = None\n"
            "sys.argv = ['teochat_torch.train.cli'] + sys.argv[1:]\n"
            "runpy.run_module('teochat_torch.train.cli', run_name='__main__')\n"
            "assert not [n for n in sys.modules if n.startswith(('jax.', 'optax.', 'teochat_tpu'))]\n")
    # one torch thread, as the test process runs (tests/_torch_threads.py)
    env = {**os.environ, "HF_DATASETS_OFFLINE": "1", "HF_HUB_OFFLINE": "1", "OMP_NUM_THREADS": "1",
           "HF_HOME": str(tmp_path / "hf"), "PYTHONPATH": REPO}

    def run(max_steps):
        proc = subprocess.run([sys.executable, "-c", code, *argv, "--max_steps", str(max_steps)],
                              capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return proc.stdout

    first = run(3)
    assert "--deepspeed ./scripts/zero3_offload.json ignored" in first
    losses = [float(x) for x in re.findall(r"step \d+/3 loss ([0-9.]+)", first)]
    assert len(losses) == 3 and all(np.isfinite(x) and x > 0 for x in losses), first
    dirs = {n: os.path.isdir(os.path.join(out, n, "opt_state")) for n in os.listdir(out)}
    assert dirs == {"checkpoint-2": True, "checkpoint-3": False}  # pruned to 1, then the final
    params3, cfg3, _ = orbax_io.load_checkpoint(os.path.join(out, "checkpoint-3"))
    assert cfg3.projector.mm_hidden_size == TOWER["hidden_size"] and cfg3.vision.image_size == 28
    assert params3["llm"]["layers"]["attn"]["q"]["kernel"].dtype == torch.int8
    assert params3["llm"]["layers"]["attn"]["q"]["lora_b"].abs().max() > 0
    assert params3["projector"]["layers"][0]["kernel"].dtype == torch.float32  # its master

    second = run(4)
    assert f"Resuming from {os.path.join(out, 'checkpoint-3')}" in second
    assert re.findall(r"step (\d+)/4 loss", second) == ["4"]
    # step 4 saved with its optimizer state, pruned to 1, then the final save
    # at the same step replaced it without (F7)
    assert {n: os.path.isdir(os.path.join(out, n, "opt_state"))
            for n in os.listdir(out)} == {"checkpoint-4": False}


def test_profile_trace_writes_a_torch_profiler_trace(tmp_path, capsys):
    """--profile_dir: a torch.profiler trace of the block (JAX's
    jax.profiler one), nothing without a dir; rank0_print prints in one
    process."""
    from teochat_torch.utils import profile_trace, rank0_print

    with profile_trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "prof" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    with profile_trace(None):
        pass
    rank0_print("on rank 0")
    assert capsys.readouterr().out == "on rank 0\n"


@pytest.mark.parametrize("model_kw", [dict(freeze_backbone=False), dict(freeze_backbone=True)],
                         ids=["every leaf", "all but the tower"])
def test_full_fine_tuning_refuses_an_int8_backbone(tmp_path, model_kw):
    """Full fine-tuning selects the int8 kernels, which have no gradient:
    the train step raises before any update, as JAX's grad would."""
    from teochat_torch.checkpoint.bridge import init_teochat
    from teochat_torch.config import tiny_test_config
    from tests.test_data_pipeline import _raw_example

    cfg = tiny_test_config(vocab_size=256)
    params = init_teochat(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32,
                          quant="int8")
    args = torch_train_mod.TrainingArguments(
        output_dir=str(tmp_path), lora_enable=False, per_device_train_batch_size=2,
        lr_scheduler_type="constant", report_to="none", bf16=False)
    with pytest.raises(ValueError, match="torch.int8, not differentiable"):
        torch_train_mod.train(torch_train_mod.ModelArguments(**model_kw),
                              torch_data.DataArguments(image_processor=TinyProcessor()), args,
                              cfg=cfg, params=params, tokenizer=MockTokenizer(),
                              dataset=[_raw_example(2, s) for s in range(2)],
                              max_steps_override=1)
    assert not list(tmp_path.iterdir())


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_rank_cli(parts, tmp_path, rank_batch, extra=()):
    """`train.cli.main --distributed` on 2 gloo ranks (per-device batch
    `rank_batch`, `extra` flags) and on one process (batch 4), both with
    accumulation 2 over the same data: (rank 0's printed losses, the one
    process's history, the ranks' and the one process's output dirs)."""
    from teochat_torch.conversation import conv_templates

    lm = str(tmp_path / "lm")
    shutil.copytree(parts["lm"], lm)
    v1 = conv_templates["v1"]
    _word_tokenizer(lm, [v1.system, *v1.roles, QUESTION, "Image 1 2 3 in chronological order",
                         "airport dam factory"])
    data = _dataset_dir(tmp_path / "data", 8)

    def argv(out, batch):
        return (f"--bits 8 --lora_enable True --lora_r 4 --lora_alpha 8 --model_name_or_path {lm} "
                f"--version v1 --data_name {data} --data_split train "
                f"--data_cache_dir {tmp_path / 'cache'} --image_tower {parts['tower']} "
                f"--mm_projector_type mlp2x_gelu --pretrain_mm_mlp_adapter {parts['adapter']} "
                f"--mm_use_im_start_end False --mm_use_im_patch_token False --bf16 False "
                f"--output_dir {out} --num_train_epochs 2 --per_device_train_batch_size {batch} "
                f"--gradient_accumulation_steps 2 "
                f"--save_strategy steps --save_steps 1 --save_total_limit 1 --learning_rate 1e-3 "
                f"--lr_scheduler_type constant --logging_steps 1 --gradient_checkpointing True "
                f"--report_to none --device cpu --max_steps 2").split()

    env = {**os.environ, "HF_DATASETS_OFFLINE": "1", "HF_HUB_OFFLINE": "1", "OMP_NUM_THREADS": "1",
           "HF_HOME": str(tmp_path / "hf"), "PYTHONPATH": REPO, "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "2"}
    out = str(tmp_path / "out")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "teochat_torch.train.cli", *argv(out, rank_batch), *extra,
         "--distributed"],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(2)]
    outputs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, outputs):
        assert p.returncode == 0, err[-3000:]
    losses = re.findall(r"step \d+/2 loss ([0-9.]+)", outputs[0][0])
    assert len(losses) == 2 and not re.findall(r"step \d+/2 loss", outputs[1][0])  # rank 0 prints
    one = str(tmp_path / "one")
    history = []
    torch_cli.main(argv(one, 4), history=history)
    return losses, history, out, one


def _checkpoints_agree(out, one):
    """The ranks' final (sharded) checkpoint, pruned to checkpoint-2, loads
    on one process within two Adam steps of the one process's."""
    assert sorted(os.listdir(out)) == ["checkpoint-2"]
    assert os.path.exists(os.path.join(out, "checkpoint-2", "params", "tree.json"))
    got, _, _ = orbax_io.load_checkpoint(os.path.join(out, "checkpoint-2"))
    want, _, _ = orbax_io.load_checkpoint(os.path.join(one, "checkpoint-2"))
    got, want = dict(tree_leaves_with_path(got)), dict(tree_leaves_with_path(want))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        if w.dtype == torch.int8:
            assert torch.equal(got[path], w), path
        else:  # two Adam steps of lr 1e-3 each way at most, summed in another order
            assert (got[path].float() - w.float()).abs().max() <= 4e-3, path


def test_cli_distributed_trains_on_two_ranks(parts, tmp_path):
    """`python -m teochat_torch.train.cli --distributed` on 2 gloo ranks under
    torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR /
    MASTER_PORT on 127.0.0.1), the default mesh (every rank on fsdp),
    accumulation 2: each rank takes its own chunks of the sampler's
    megabatches, and the losses rank 0 prints equal a one-process run of
    the global batch (2 rows a rank against 4 on one process) to the
    printed 4 decimals; the sharded
    checkpoints are pruned and the final one loads on one process, its
    leaves within Adam's steps of the one process's."""
    losses, history, out, one = _two_rank_cli(parts, tmp_path, 2)
    assert [f"{h['loss']:.4f}" for h in history] == losses
    _checkpoints_agree(out, one)


@pytest.mark.parametrize("flags", ["--mesh_fsdp 1 --mesh_sequence 2",
                                   "--mesh_fsdp 1 --mesh_pipe 2 --pipeline_microbatches 2"],
                         ids=["sequence", "pipe"])
def test_cli_distributed_trains_on_sequence_and_pipe_meshes(parts, tmp_path, flags):
    """The same run on mesh (1, 1, 1, sequence 2), the ring (each rank half
    of every row's 256 bucketed tokens), and on (1, 1, 1, pipe 2), GPipe in
    2 microbatches (each rank one of the 2 layers): both ranks take all 4
    rows, and rank 0 prints the one process's losses to the printed 4
    decimals; the final checkpoint loads on one process within Adam's
    steps, and its config carries neither axis (the run's switches only)."""
    losses, history, out, one = _two_rank_cli(parts, tmp_path, 4, flags.split())
    assert [f"{h['loss']:.4f}" for h in history] == losses
    _checkpoints_agree(out, one)
    with open(os.path.join(out, "checkpoint-2", "config.json")) as f:
        llm = json.load(f)["llm"]
    assert llm["sequence_axis"] is None and llm["pipeline_axis"] is None
    assert llm["pipeline_microbatches"] is None


@pytest.mark.parametrize("flag", ["--mesh_sequence", "--mesh_pipe"])
def test_sequence_or_pipe_axis_on_one_process_raises(parts, tmp_path, flag):
    """An axis above 1 with one process has no ranks to split: a ValueError
    naming the flag, as JAX's driver raises on one device, before anything
    is saved."""
    out = tmp_path / "out"
    argv = (f"--model_name_or_path {parts['lm']} --image_tower {parts['tower']} "
            f"--mm_projector_type mlp2x_gelu --output_dir {out} --device cpu "
            f"--report_to none {flag} 2").split()
    with pytest.raises(ValueError, match=f"{flag} 2 needs a multi-device runtime"):
        torch_cli.main(argv)
    assert not out.exists()
