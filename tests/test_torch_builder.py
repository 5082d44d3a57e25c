"""The port's checkpoint loader, preprocessing and tower against the JAX package.

One tiny TEOChat checkpoint in the HF layout (fp16 `pytorch_model-*.bin`
shards, again as safetensors, config.json and a word-level tokenizer.json)
is written to a temp dir and loaded by both packages' `load_pretrained_model`
(merged bf16, `load_8bit`, `load_int4`, and branch B: a projector-only dir
over a base). The parameter trees must be equal, the last-position prefill
logits close and the greedy tokens equal. The converters, the host
quantizers, `ImageProcessor` (PIL and native paths) and the native build are
held to their JAX twins exactly; `VisionTower` to JAX's and to HF's CLIP.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from teochat_tpu import builder as jax_builder
from teochat_tpu import native as jax_native
from teochat_tpu.checkpoint import convert_hf as jax_convert
from teochat_tpu.config import GenerationConfig, VisionConfig
from teochat_tpu.constants import IMAGE_TOKEN_INDEX as IMG
from teochat_tpu.data import processing as jax_processing
from teochat_tpu.models import fusion as jax_fusion
from teochat_tpu.models import llama as jax_llama
from teochat_tpu.models import teochat as jax_teochat
from teochat_tpu.models import towers as jax_towers
from teochat_tpu.models import vit as jax_vit
from teochat_tpu.ops import quant as jax_quant
from teochat_torch import builder as torch_builder
from teochat_torch import native as torch_native
from teochat_torch.checkpoint import convert_hf as torch_convert
from teochat_torch.config import VisionConfig as TorchVisionConfig
from teochat_torch.data import processing as torch_processing
from teochat_torch.models import fusion as torch_fusion
from teochat_torch.models import llama as torch_llama
from teochat_torch.models import teochat as torch_teochat
from teochat_torch.models import towers as torch_towers
from teochat_torch.ops import quant as torch_quant
from teochat_torch.utils import tree_leaves_with_path
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tiny model: a 2-layer LLaMA (d 64, 4 heads, MLP 256: the fused int4
# gate|up is 512 wide, one tile of packed_tiles; q|k|v, out and down stay flat
# `packed`), a 640-token vocabulary (the lm_head is two int4 tiles), a 2-layer
# CLIP tower on 28-pixel frames (2 x 2 patches of 14), an mlp2x projector
VOCAB, D, INTER, LAYERS, HEADS = 640, 64, 256, 2, 4
TOWER = dict(image_size=28, patch_size=14, hidden_size=32, intermediate_size=64,
             num_layers=2, num_heads=4)
TOWER_PREFIX = "model.image_tower.image_tower.vision_model."
HOT = [5, 77, 130, 201, 333, 402, 517, 600]
GREEDY = GenerationConfig(max_new_tokens=6, temperature=0.0, do_sample=False, stop_strings=())
# last-position prefill logits, port vs JAX on the same bf16 (or int8 / int4)
# weights: two bf16 decoders whose hidden states differ by a bf16 rounding
# here and there. In fp32 the two agree to 2e-5 of logits up to ~110; in bf16
# each is 0.17-0.19 from its own fp32 logits and 0.13-0.64 from the other's
# (read along the greedy path of the merged load), so they are held to 1 % of
# the largest |logit|, and the top two JAX logits must lie further apart
PREFILL_LOGITS_RTOL = 1e-2


def hf_config(**over):
    cfg = {
        "architectures": ["LlavaLlamaForCausalLM"], "model_type": "llava",
        "vocab_size": VOCAB, "hidden_size": D, "intermediate_size": INTER,
        "num_hidden_layers": LAYERS, "num_attention_heads": HEADS,
        "num_key_value_heads": HEADS, "rms_norm_eps": 1e-5,
        "max_position_embeddings": 512, "mm_projector_type": "mlp2x_gelu",
        "mm_hidden_size": TOWER["hidden_size"], "mm_vision_select_layer": -2,
        "mm_vision_select_feature": "patch", "mm_use_im_patch_token": False,
        "mm_use_im_start_end": False, "tokenizer_model_max_length": 256,
        "max_sequence_length": 128,
    }
    cfg.update(over)
    return cfg


def write_tokenizer(path, vocab_size=VOCAB):
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for i in range(3, vocab_size):
        vocab[f"w{i}"] = i
    tok = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>"}, f)


def tiny_state_dict(seed=0, layers=LAYERS, dtype=torch.float16, tower=True, projector=True):
    """An HF state dict of the tiny TEOChat, drawn from `seed`."""
    g = torch.Generator().manual_seed(seed)

    def w(*shape, std=0.05):
        return (torch.randn(*shape, generator=g) * std).to(dtype)

    def norm(*shape):
        return (1.0 + torch.randn(*shape, generator=g) * 0.1).to(dtype)

    # the lm_head's rows of HOT tokens are 6 times the others: the top logit
    # is a hot token's, well clear of the next (greedy ties cannot flip)
    head = torch.randn(VOCAB, D, generator=g)
    head[HOT] *= 6.0
    sd = {"model.embed_tokens.weight": w(VOCAB, D, std=0.5), "model.norm.weight": norm(D),
          "lm_head.weight": head.to(dtype)}
    for i in range(layers):
        p = f"model.layers.{i}."
        for name, shape in (("self_attn.q_proj", (D, D)), ("self_attn.k_proj", (D, D)),
                            ("self_attn.v_proj", (D, D)), ("self_attn.o_proj", (D, D)),
                            ("mlp.gate_proj", (INTER, D)), ("mlp.up_proj", (INTER, D)),
                            ("mlp.down_proj", (D, INTER))):
            sd[p + name + ".weight"] = w(*shape, std=0.05)
        sd[p + "input_layernorm.weight"] = norm(D)
        sd[p + "post_attention_layernorm.weight"] = norm(D)
    if projector:
        m, h = TOWER["hidden_size"], D
        sd.update({"model.mm_projector.0.weight": w(h, m, std=0.2),
                   "model.mm_projector.0.bias": w(h),
                   "model.mm_projector.2.weight": w(h, h, std=0.2),
                   "model.mm_projector.2.bias": w(h)})
    if tower:
        d, ff, n_pos = TOWER["hidden_size"], TOWER["intermediate_size"], 5
        vt = TOWER_PREFIX
        sd[vt + "embeddings.patch_embedding.weight"] = w(d, 3, 14, 14)
        sd[vt + "embeddings.class_embedding"] = w(d)
        sd[vt + "embeddings.position_embedding.weight"] = w(n_pos, d)
        for ln in ("pre_layrnorm", "post_layernorm"):
            sd[vt + ln + ".weight"], sd[vt + ln + ".bias"] = norm(d), w(d)
        for i in range(TOWER["num_layers"]):
            e = vt + f"encoder.layers.{i}."
            for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[e + f"self_attn.{n}.weight"], sd[e + f"self_attn.{n}.bias"] = w(d, d, std=0.2), w(d)
            for ln in ("layer_norm1", "layer_norm2"):
                sd[e + ln + ".weight"], sd[e + ln + ".bias"] = norm(d), w(d)
            sd[e + "mlp.fc1.weight"], sd[e + "mlp.fc1.bias"] = w(ff, d, std=0.2), w(ff)
            sd[e + "mlp.fc2.weight"], sd[e + "mlp.fc2.bias"] = w(d, ff, std=0.2), w(d)
    return sd


def write_checkpoint(path, sd, fmt="bin", n_shards=2, config=None):
    """`sd` as an HF checkpoint dir: shards of whole layers, config.json and the tokenizer."""
    os.makedirs(path, exist_ok=True)
    keys = sorted(sd)
    shards = [keys[i::n_shards] for i in range(n_shards)]
    for i, names in enumerate(shards):
        part = {k: sd[k].contiguous() for k in names}
        if fmt == "bin":
            torch.save(part, os.path.join(path, f"pytorch_model-{i + 1:05d}-of-{n_shards:05d}.bin"))
        else:
            from safetensors.torch import save_file

            save_file(part, os.path.join(path, f"model-{i + 1:05d}-of-{n_shards:05d}.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config or hf_config(), f)
    write_tokenizer(path)
    return str(path)


def _tiny_tower_config(orig):
    def load_config(model_path):
        cfg = orig(model_path)
        return dataclasses.replace(cfg, vision=type(cfg.vision)(**TOWER))
    return load_config


@pytest.fixture(scope="module")
def tiny_towers():
    """Both packages' load_config with the tiny tower (they assume ViT-L/14)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_builder, "load_config", _tiny_tower_config(jax_builder.load_config))
        mp.setattr(torch_builder, "load_config", _tiny_tower_config(torch_builder.load_config))
        yield


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_builder")
    sd = tiny_state_dict()
    base_sd = {k: v for k, v in sd.items() if "mm_projector" not in k}
    out = {
        "TEOChat-tiny": write_checkpoint(root / "TEOChat-tiny", sd),
        "safetensors": write_checkpoint(root / "TEOChat-tiny-st", sd, fmt="safetensors"),
        "base": write_checkpoint(root / "base", base_sd, n_shards=1),
    }
    # branch B's projector-only dir: another projector than the merged one's
    proj = {k: v for k, v in tiny_state_dict(seed=3).items() if "mm_projector" in k}
    os.makedirs(root / "projector-only")
    torch.save(proj, root / "projector-only" / "mm_projector.bin")
    out["projector-only"] = str(root / "projector-only")
    out["sd"], out["proj"] = sd, proj
    return out


def write_lora_dir(path, seed, config=None):
    """Branch A's dir (the reference's LoRA fine-tune over a base;
    tests/test_torch_multi_lora.py loads it):
    config.json and the tokenizer, a peft adapter (fp16 A / B of rank 4 on
    every projection, alpha 8), and non_lora_trainables.bin with a
    projector and embed rows of their own, under peft's key prefix."""
    from safetensors.torch import save_file

    write_checkpoint(path, {}, n_shards=0, config=config)
    g = torch.Generator().manual_seed(seed)
    rank, widths = 4, {"self_attn.q_proj": (D, D), "self_attn.k_proj": (D, D),
                       "self_attn.v_proj": (D, D), "self_attn.o_proj": (D, D),
                       "mlp.gate_proj": (D, INTER), "mlp.up_proj": (D, INTER),
                       "mlp.down_proj": (INTER, D)}
    adapter = {}
    for i in range(LAYERS):
        for mod, (fan_in, fan_out) in widths.items():
            pre = f"base_model.model.model.layers.{i}.{mod}"
            adapter[f"{pre}.lora_A.weight"] = (torch.randn(rank, fan_in, generator=g) * 0.05).half()
            adapter[f"{pre}.lora_B.weight"] = (torch.randn(fan_out, rank, generator=g) * 0.05).half()
    save_file(adapter, os.path.join(path, "adapter_model.safetensors"))
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": rank, "lora_alpha": 2 * rank}, f)
    nlt = {k: v for k, v in tiny_state_dict(seed=seed, tower=False).items()
           if "mm_projector" in k or "embed_tokens" in k}
    torch.save({"base_model.model." + k: v for k, v in nlt.items()},
               os.path.join(path, "non_lora_trainables.bin"))
    return str(path)


LOADS = {  # name: (model_path, model_base, kwargs)
    "merged": ("TEOChat-tiny", None, {}),
    "8bit": ("TEOChat-tiny", None, {"load_8bit": True}),
    "int4": ("TEOChat-tiny", None, {"load_int4": True}),
    "projector-only": ("projector-only", "base", {}),
    "safetensors 8bit": ("safetensors", None, {"load_8bit": True}),
}


@pytest.fixture(scope="module")
def loaded(ckpts, tiny_towers):
    """Each load of LOADS in both packages, made once: {name: (jax bundle, torch bundle)}."""
    cache = {}

    def get(name):
        if name not in cache:
            path, base, kwargs = LOADS[name]
            args = (ckpts[path], ckpts[base] if base else None)
            cache[name] = (jax_builder.load_pretrained_model(*args, **kwargs),
                           torch_builder.load_pretrained_model(*args, device="cpu", **kwargs))
        return cache[name]
    return get


def _np_leaves(tree):
    out = {}
    for path, leaf in tree_leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            out[path] = leaf.detach().float().numpy() if leaf.is_floating_point() else leaf.numpy()
        else:
            a = np.asarray(leaf)
            out[path] = a.astype(np.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a
    return out


def assert_trees_equal(torch_tree, jax_tree):
    """The same paths, shapes and dtypes (floats compared as fp32), and the
    same values, exactly."""
    got, want = _np_leaves(torch_tree), _np_leaves(jax_tree)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, (path, g.shape, w.shape, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=path)


PROMPT_IDS = [1, 5, 9, IMG, 17, 3, IMG, 40, 41, 42]
_jax_forward = jax.jit(jax_llama.llama_forward, static_argnames=("cfg",))


def _frames(n=2, size=28, seed=4):
    return np.random.RandomState(seed).randn(n, 3, size, size).astype(np.float32)


def _prefill_logits(jm, tm, ids, frames):
    """Last-position prefill logits of one prompt, fp32, in both packages."""
    tpf = tm.tokens_per_frame
    plan_j = jax_fusion.build_fusion_plan([ids], tokens_per_frame=tpf, pad_to=32)
    plan_t = torch_fusion.build_fusion_plan([ids], tokens_per_frame=tpf, pad_to=32)
    last = int(plan_t.seq_lens[0]) - 1
    emb_j = jax_teochat.multimodal_embeds(jm.params, jm.cfg, plan_j, jm.encode(frames))
    want, _ = _jax_forward(jm.params["llm"], jm.cfg.llm, emb_j,
                           position_ids=jnp.asarray(plan_j.position_ids),
                           attention_mask=jnp.asarray(plan_j.attention_mask))
    with torch.no_grad():
        emb_t = torch_teochat.multimodal_embeds(tm.params, tm.cfg, plan_t, tm.encode(frames))
        got = torch_llama.llama_forward(tm.params["llm"], tm.cfg.llm, emb_t,
                                        position_ids=torch.as_tensor(plan_t.position_ids),
                                        attention_mask=torch.as_tensor(plan_t.attention_mask))
    return got[0, last].float().numpy(), np.asarray(want[0, last], np.float32)


@pytest.mark.parametrize("name", list(LOADS))
def test_load_pretrained_model_matches_jax(loaded, name):
    (jtok, jm, jproc, jctx), (ttok, tm, tproc, tctx) = loaded(name)
    assert tctx == jctx == 128 and len(ttok) == len(jtok) == VOCAB
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert tproc["image"].size == jproc["image"].size == 28
    assert_trees_equal(tm.params, jm.params)
    assert tm.device.type == "cpu"
    frames = _frames()
    got, want = _prefill_logits(jm, tm, PROMPT_IDS, frames)
    tol = PREFILL_LOGITS_RTOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    top2 = np.sort(want)[-2:]
    assert top2[1] - top2[0] > 2 * tol  # a top token the tolerance cannot flip
    assert int(np.argmax(got)) == int(np.argmax(want))
    assert tm.generate([PROMPT_IDS], frames, GREEDY) == jm.generate([PROMPT_IDS], frames, GREEDY)


def test_load_variants_hold_the_checkpoint(loaded, ckpts):
    """What each load keeps: int8 q / k / v unfused, int4 q|k|v and gate|up
    fused; branch B takes the projector-only dir's projector; a safetensors
    checkpoint loads the same tree as the .bin one."""
    llm8 = loaded("8bit")[1][1].params["llm"]["layers"]
    assert llm8["attn"]["q"]["kernel"].dtype == torch.int8 and "scale" in llm8["attn"]["q"]
    llm4 = loaded("int4")[1][1].params["llm"]
    assert set(llm4["layers"]["attn"]) == {"qkv", "out"} and set(llm4["layers"]["mlp"]) == {"gateup", "down"}
    assert "packed_tiles" in llm4["layers"]["mlp"]["gateup"] and "packed_tiles" in llm4["lm_head"]
    assert "packed" in llm4["layers"]["attn"]["qkv"]
    proj = loaded("projector-only")[1][1].params["projector"]["layers"][0]["kernel"]
    want = ckpts["proj"]["model.mm_projector.0.weight"].T.to(torch.bfloat16)
    assert torch.equal(proj, want)
    merged = loaded("merged")[1][1].params["projector"]["layers"][0]["kernel"]
    assert not torch.equal(merged, want)
    assert_trees_equal(loaded("safetensors 8bit")[1][1].params, loaded("8bit")[1][1].params)


@pytest.mark.parametrize("case", ["mpt", "load_4bit"])
def test_load_raises_for_what_is_not_ported(ckpts, tiny_towers, tmp_path, case):
    path = ckpts["TEOChat-tiny"]
    kwargs = dict(device="cpu")
    args = (path, None, None)
    if case == "mpt":  # the MPT loader takes bf16 and load_8bit; int4 raises as in JAX
        args = (path, None, "llava-mpt-7b")
        kwargs["load_int4"] = True
    else:
        kwargs[case] = True
    with pytest.raises(NotImplementedError, match="ROADMAP item 1[2-5]|nf4|llama backend"):
        torch_builder.load_pretrained_model(*args, **kwargs)


def _grown_lora_dir(path, n_new):
    """Branch A's dir after a fine-tune that grew the tokenizer by `n_new`
    tokens: its config and tokenizer declare the larger vocab, and its
    non-LoRA trainables hold the trained embedding of that many rows."""
    lora = write_lora_dir(path, seed=5, config=hf_config(vocab_size=VOCAB + n_new))
    write_tokenizer(lora, VOCAB + n_new)
    nlt_file = os.path.join(lora, "non_lora_trainables.bin")
    nlt = torch.load(nlt_file, weights_only=True)
    key = "base_model.model.model.embed_tokens.weight"
    extra = torch.randn(n_new, D, generator=torch.Generator().manual_seed(9)).half() * 0.5
    nlt[key] = torch.cat([nlt[key], extra])
    torch.save(nlt, nlt_file)
    return lora


@pytest.mark.parametrize("case", ["lora vocab", "quantize_vision", "vocab", "patch_token",
                                  "allow_partial", "start_end 8bit"])
def test_vision_extras_load_and_match_jax(ckpts, tiny_towers, tmp_path, case):
    """The loads the vision extras allow, in both packages: branch A over a
    base whose vocab its LoRA dir grew; the w8a8 tower (`quantize_vision`);
    an embedding with more rows than the tokenizer has tokens (truncated);
    `mm_use_im_patch_token` (one token added, the embedding and lm_head grown
    by their mean); a plain LM loaded partial past the vision tokens; and
    `mm_use_im_start_end` over an 8-bit load (four tokens added and the
    lm_head resized on the host before it is quantized). The same config,
    tokenizer length and tree, and where the model is whole the prefill
    logits and greedy tokens of test_load_pretrained_model_matches_jax."""
    kwargs = {}
    args = (ckpts["TEOChat-tiny"], None)
    if case == "lora vocab":
        args = (_grown_lora_dir(tmp_path / "teochat-lora", 3), ckpts["base"])
    elif case == "quantize_vision":
        kwargs["quantize_vision"] = True
    elif case == "allow_partial":
        sd = {k: v for k, v in ckpts["sd"].items()
              if "mm_projector" not in k and "image_tower" not in k}
        args = (write_checkpoint(tmp_path / case, sd, n_shards=1,
                                 config=hf_config(mm_use_im_patch_token=True)), None)
        kwargs[case] = True
    else:
        sd = dict(ckpts["sd"])
        config = {"vocab": hf_config(), "patch_token": hf_config(mm_use_im_patch_token=True),
                  "start_end 8bit": hf_config(mm_use_im_start_end=True)}[case]
        if case == "vocab":  # the embedding has more rows than the tokenizer has tokens
            sd["model.embed_tokens.weight"] = torch.cat([sd["model.embed_tokens.weight"]] * 2)
        if case == "start_end 8bit":
            kwargs["load_8bit"] = True
        args = (write_checkpoint(tmp_path / case.split()[0], sd, n_shards=1, config=config), None)
    jtok, jm, jproc, _ = jax_builder.load_pretrained_model(*args, **kwargs)
    ttok, tm, tproc, _ = torch_builder.load_pretrained_model(*args, device="cpu", **kwargs)
    n_vocab = {"lora vocab": VOCAB + 3, "patch_token": VOCAB + 1, "allow_partial": VOCAB + 1,
               "start_end 8bit": VOCAB + 4}.get(case, VOCAB)
    assert len(ttok) == len(jtok) == n_vocab == tm.cfg.llm.vocab_size
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert_trees_equal(tm.params, jm.params)
    assert tm.params["llm"]["embed_tokens"]["embedding"].shape[0] == n_vocab
    if case == "quantize_vision":
        q = tm.params["vision"]["layers"]["attn"]["q"]
        assert q["kernel"].dtype == torch.int8 and set(q) == {"kernel", "scale", "bias"}
    if case == "allow_partial":
        assert set(tm.params) == {"llm"}
        return
    frames = _frames()
    got, want = _prefill_logits(jm, tm, PROMPT_IDS, frames)
    tol = PREFILL_LOGITS_RTOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert int(np.argmax(got)) == int(np.argmax(want))
    assert tm.generate([PROMPT_IDS], frames, GREEDY) == jm.generate([PROMPT_IDS], frames, GREEDY)


def test_load_defaults_to_the_card_and_the_video_processor_raises(ckpts, tiny_towers):
    """Without a card the default device raises; the processor dict's video
    entry is the port's VideoProcessor, which gives the JAX one's pixels on
    decoded frames (tests/test_torch_host_copies.py holds it further)."""
    from teochat_tpu.data.processing_extra import VideoProcessor as JaxVideoProcessor

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_builder.load_pretrained_model(ckpts["TEOChat-tiny"])
    video = torch_builder.load_pretrained_model(ckpts["TEOChat-tiny"], device="cpu")[2]["video"]
    clip = np.random.RandomState(0).randint(0, 256, (10, 40, 52, 3), np.uint8)
    want = JaxVideoProcessor(size=28).preprocess(clip)["pixel_values"]
    for call in (video, video.preprocess):
        np.testing.assert_array_equal(call(clip)["pixel_values"], want)
    assert want.shape == (1, 8, 3, 28, 28)


def test_load_config_and_strip_prefix_match_jax(ckpts):
    for path in (ckpts["TEOChat-tiny"], ckpts["base"]):
        assert dataclasses.asdict(torch_builder.load_config(path)) == \
            dataclasses.asdict(jax_builder.load_config(path))
    sd = {"base_model.model.model.mm_projector.0.weight": 1, "lm_head.weight": 2}
    assert torch_builder._strip_prefix(sd) == jax_builder._strip_prefix(sd)
    assert len(torch_builder._load_state_dict(ckpts["TEOChat-tiny"])) == len(ckpts["sd"])


# ------------------------------------------------------------ converters


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
def test_converters_match_jax(dtype):
    """The same keys, shapes and values, exactly; 16-bit leaves keep 2 bytes
    in the port (the JAX converter widens bf16 to fp32)."""
    from teochat_tpu.config import LlamaConfig, ProjectorConfig

    sd = tiny_state_dict(seed=1, dtype=dtype)
    vcfg = VisionConfig(**TOWER)
    lcfg = LlamaConfig(vocab_size=VOCAB, hidden_size=D, intermediate_size=INTER,
                       num_layers=LAYERS, num_heads=HEADS, num_kv_heads=HEADS)
    pcfg = ProjectorConfig(mm_hidden_size=TOWER["hidden_size"], hidden_size=D)
    cases = [
        (torch_convert.convert_clip_vision, jax_convert.convert_clip_vision, vcfg,
         {"prefix": TOWER_PREFIX}),
        (torch_convert.convert_llama, jax_convert.convert_llama, lcfg, {}),
        (torch_convert.convert_projector, jax_convert.convert_projector, pcfg, {}),
    ]
    for port, ref, cfg, kw in cases:
        got, want = port(sd, cfg, **kw), ref(sd, cfg, **kw)
        assert_trees_equal(got, want)
        for path, leaf in tree_leaves_with_path(got):
            assert leaf.device.type == "cpu" and leaf.is_contiguous(), path
            if "ln" not in path and "layernorm" not in path:  # LN leaves are fp32 in both
                assert leaf.dtype == dtype, (path, leaf.dtype)
    # a bare projector dict (`0.weight`) and a linear one
    bare = {k.split("mm_projector.")[1]: v for k, v in sd.items() if "mm_projector" in k}
    assert_trees_equal(torch_convert.convert_projector(bare, pcfg),
                       jax_convert.convert_projector(bare, pcfg))
    lin = ProjectorConfig(projector_type="linear", mm_hidden_size=TOWER["hidden_size"], hidden_size=D)
    one = {"weight": bare["0.weight"], "bias": bare["0.bias"]}
    assert_trees_equal(torch_convert.convert_projector(one, lin), jax_convert.convert_projector(one, lin))
    with pytest.raises(ValueError, match="depth mismatch"):
        torch_convert.convert_projector({"0.weight": one["weight"], "0.bias": one["bias"]}, pcfg)


# ------------------------------------------------------- host quantizers


@pytest.fixture(scope="module")
def host_llama():
    """A 4-layer host decoder tree (fp16 leaves) and JAX's two host quantizations of it."""
    from teochat_tpu.config import LlamaConfig

    cfg = LlamaConfig(vocab_size=VOCAB, hidden_size=D, intermediate_size=INTER,
                      num_layers=4, num_heads=HEADS, num_kv_heads=HEADS)
    sd = tiny_state_dict(seed=2, layers=4, tower=False, projector=False)
    port_tree = torch_convert.convert_llama(sd, cfg)
    jax_tree = jax_convert.convert_llama(sd, cfg)
    want = {int4: jax_quant.quantize_llama_params_host(jax_tree, int4=int4) for int4 in (False, True)}
    return port_tree, want


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("layer_chunk", [1, 3, 4])
def test_quantize_llama_params_host_matches_jax(host_llama, int4, layer_chunk):
    """int8 bytes and packed int4 bytes equal, scales within one fp32 ulp,
    and the same tree whatever the chunk (1, 3: a ragged last chunk, L)."""
    port_tree, want = host_llama
    got = torch_quant.quantize_llama_params_host(port_tree, int4=int4, layer_chunk=layer_chunk,
                                                 device="cpu")
    assert_trees_equal(got, want[int4])
    whole = torch_quant.quantize_llama_params_host(port_tree, int4=int4, layer_chunk=4,
                                                   device="cpu")
    for (path, a), (_, b) in zip(tree_leaves_with_path(got), tree_leaves_with_path(whole)):
        assert torch.equal(a, b), path


def test_quantize_kernel_host_keeps_inputs_and_matches_the_whole_kernel():
    """The host quantizer does not touch its input (the quantizers work on an
    fp32 copy in place) and gives, chunk by chunk, its result on the whole
    kernel at once."""
    w = torch.randn(5, 64, 48, generator=torch.Generator().manual_seed(3))
    before = w.clone()
    got = torch_quant.quantize_kernel_host(w, layer_chunk=2, device="cpu")
    assert torch.equal(w, before)
    want = torch_quant.quantize_kernel_host(w, layer_chunk=5, device="cpu")
    assert torch.equal(got["kernel"], want["kernel"]) and torch.equal(got["scale"], want["scale"])
    w32 = torch.randn(64, 600, generator=torch.Generator().manual_seed(4))
    before = w32.clone()
    torch_quant.quantize_kernel_int4(w32)
    assert torch.equal(w32, before)


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
def test_quantizer_scales_match_jax_eager_and_jit(int4):
    """JAX's quantizers divide amax by 127 (or 7) when run eagerly and
    multiply by the reciprocal under jit (XLA's rewrite): the port's device
    quantizer gives the eager bytes and scales exactly, its host quantizer
    (JAX's host path runs under jit) the jitted ones; across forms some
    scales are an ulp apart."""
    w = np.random.RandomState(9).randn(3, 256, 520).astype(np.float16) * 0.05
    ref = jax_quant.quantize_kernel_int4 if int4 else jax_quant.quantize_kernel
    port = torch_quant.quantize_kernel_int4 if int4 else torch_quant.quantize_kernel
    eager, jitted = ref(jnp.asarray(w)), jax.jit(ref)(jnp.asarray(w))
    assert_trees_equal(port(torch.from_numpy(w)), eager)
    assert_trees_equal(torch_quant.quantize_kernel_host(torch.from_numpy(w), int4=int4,
                                                        layer_chunk=2, device="cpu"), jitted)
    assert (np.asarray(eager["scale"]) != np.asarray(jitted["scale"])).any()


# ----------------------------------------------------------- preprocessing


def _images():
    rs = np.random.RandomState(5)
    arrays = [rs.randint(0, 256, shape, dtype=np.uint8)
              for shape in ((37, 51, 3), (61, 29, 3), (28, 28, 3), (300, 400, 3), (257, 255, 3))]
    return arrays + [rs.rand(33, 45, 3).astype(np.float32)]


@pytest.mark.parametrize("use_native", [False, True], ids=["pil", "native"])
@pytest.mark.parametrize("size", [28, 224])
def test_image_processor_matches_jax(use_native, size):
    from PIL import Image

    if use_native:
        assert torch_native.available() and jax_native.available()
    images = _images()
    images.append(Image.fromarray(images[0]))
    got = torch_processing.ImageProcessor(size=size, use_native=use_native).preprocess(images)
    want = jax_processing.ImageProcessor(size=size, use_native=use_native).preprocess(images)
    assert got["pixel_values"].dtype == np.float32
    assert got["pixel_values"].shape == (len(images), 3, size, size)
    np.testing.assert_array_equal(got["pixel_values"], want["pixel_values"])


def test_native_build_matches_jax_native():
    assert torch_native.available()
    so = os.path.realpath(torch_native._lib._name)
    assert so.startswith(os.path.join(REPO, "teochat_torch", "csrc", "build") + os.sep), so
    with open(os.path.join(REPO, "teochat_tpu", "native", "preprocess.cc")) as f:
        ref = [line for line in f if not line.startswith("//")]
    with open(os.path.join(REPO, "teochat_torch", "native", "preprocess.cc")) as f:
        assert [line for line in f if not line.startswith("//")] == ref  # the code is a copy
    rs = np.random.RandomState(6)
    for shape, out in (((40, 53, 3), (17, 23)), ((9, 300, 3), (224, 224)), ((224, 224, 3), (224, 224))):
        src = rs.randint(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(torch_native.resize_bicubic(src, *out),
                                      jax_native.resize_bicubic(src, *out))
    frames = [rs.randint(0, 256, s, dtype=np.uint8) for s in ((300, 400, 3), (256, 320, 3), (31, 17, 3))]
    mean, std = (0.1, 0.2, 0.3), (0.5, 0.6, 0.7)
    np.testing.assert_array_equal(torch_native.preprocess_batch(frames, 32, mean, std, n_threads=2),
                                  jax_native.preprocess_batch(frames, 32, mean, std))
    with pytest.raises(ValueError, match="expected"):
        torch_native.preprocess_batch([frames[0][..., :2]], 32, mean, std)


def test_uint8_frames_need_no_pillow(tmp_path):
    """With Pillow made unimportable, uint8 [h, w, 3] frames go through the
    native path and give the bytes JAX's processor gives."""
    images = _images()[:5]
    want = jax_processing.ImageProcessor(size=224).preprocess(images)["pixel_values"]
    code = (
        "import sys, numpy as np\n"
        "sys.modules['PIL'] = None\n"
        "from teochat_torch.data.processing import ImageProcessor\n"
        "rs = np.random.RandomState(5)\n"
        "images = [rs.randint(0, 256, s, dtype=np.uint8) for s in "
        "((37, 51, 3), (61, 29, 3), (28, 28, 3), (300, 400, 3), (257, 255, 3))]\n"
        "out = ImageProcessor(size=224).preprocess(images)['pixel_values']\n"
        "assert 'PIL.Image' not in sys.modules\n"
        "np.save(sys.argv[1], out)\n"
        "try:\n"
        "    ImageProcessor(size=224).preprocess([np.zeros((4, 4), np.uint8)])\n"
        "except ImportError:\n"
        "    print('a grey frame needs PIL')\n"
    )
    out = str(tmp_path / "pixels.npy")
    res = subprocess.run([sys.executable, "-c", code, out], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "a grey frame needs PIL" in res.stdout
    np.testing.assert_array_equal(np.load(out), want)


# ------------------------------------------------------------------ tower


@pytest.fixture(scope="module")
def hf_clip():
    from transformers import CLIPVisionConfig, CLIPVisionModel

    torch.manual_seed(0)
    cfg = CLIPVisionConfig(image_size=28, patch_size=14, hidden_size=32, intermediate_size=64,
                           num_hidden_layers=3, num_attention_heads=4, hidden_act="quick_gelu")
    return CLIPVisionModel(cfg).eval()


def test_vision_tower_matches_hf_clip_and_jax(hf_clip):
    vcfg = dict(image_size=28, patch_size=14, hidden_size=32, intermediate_size=64,
                num_layers=3, num_heads=4)
    sd = hf_clip.state_dict()
    x = np.random.RandomState(0).randn(2, 3, 28, 28).astype(np.float32)
    with torch.no_grad():
        hf = hf_clip(torch.from_numpy(x), output_hidden_states=True).hidden_states
    params = torch_convert.convert_clip_vision(sd, TorchVisionConfig(**vcfg))
    jparams = jax_convert.convert_clip_vision(sd, VisionConfig(**vcfg))
    for select_layer, feature in ((-2, "patch"), (-1, "cls_patch"), (1, "patch")):
        tower = torch_towers.build_vision_tower(
            "LanguageBind/LanguageBind_Image", base_cfg=TorchVisionConfig(**vcfg),
            select_layer=select_layer, select_feature=feature).load_model(params)
        jtower = jax_towers.build_vision_tower(
            "LanguageBind/LanguageBind_Image", base_cfg=VisionConfig(**vcfg),
            select_layer=select_layer, select_feature=feature).load_model(jparams)
        with torch.no_grad():
            got = tower(torch.from_numpy(x)).numpy()
        want_hf = hf[select_layer].numpy()
        want_hf = want_hf[:, 1:] if feature == "patch" else want_hf
        np.testing.assert_allclose(got, want_hf, atol=2e-5, rtol=1e-4)
        jax_out = jax.jit(jtower.__call__)(jnp.asarray(x))  # one compile, not one per op
        np.testing.assert_allclose(got, np.asarray(jax_out), atol=2e-5, rtol=1e-4)
        assert tower.hidden_size == 32 and tower.num_patches == 4
    # encode_videos folds [B, T] frames and unfolds their features
    vids = torch.from_numpy(x).reshape(1, 2, 3, 28, 28)
    with torch.no_grad():
        got = tower.encode_videos(vids)
        want = tower(torch.from_numpy(x))
    assert got.shape == (1, 2, 4, 32) and torch.equal(got[0], want)


def test_vision_tower_builder_and_random_init():
    tower = torch_towers.build_vision_tower("openai/clip-vit-large-patch14")
    assert not tower.cfg.add_time_attn and tower.params is None
    with pytest.raises(RuntimeError, match="load_model"):
        tower(torch.zeros(1, 3, 224, 224))
    small = torch_towers.build_vision_tower("laion/clip", base_cfg=TorchVisionConfig(**TOWER))
    small.load_model(device="cpu")
    jcfg = jax_towers.build_vision_tower("laion/clip", base_cfg=VisionConfig(**TOWER)).cfg
    want = jax.eval_shape(lambda: jax_vit.init_vit(jax.random.PRNGKey(0), jcfg))  # no compile
    assert {p: tuple(x.shape) for p, x in tree_leaves_with_path(small.params)} == \
        {p: tuple(x.shape) for p, x in tree_leaves_with_path(want)}
    with torch.no_grad():
        assert small(torch.zeros(2, 3, 28, 28)).shape == (2, 4, 32)
    for name in ("LanguageBind_Video_merge", "LanguageBind_Audio", "LanguageBind_Depth",
                 "LanguageBind_Thermal"):  # each tower's config is JAX's
        assert dataclasses.asdict(torch_towers.build_vision_tower(name).cfg) == \
            dataclasses.asdict(jax_towers.build_vision_tower(name).cfg)
    assert torch_towers.build_video_tower().cfg.add_time_attn
    with pytest.raises(ValueError, match="Unknown"):
        torch_towers.build_vision_tower("resnet50")
