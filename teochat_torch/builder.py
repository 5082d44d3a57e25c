"""Model loading from a local HF-layout checkpoint dir (port of teochat_tpu/builder.py).

Rebuild of videollava/model/builder.py:27-171 `load_pretrained_model`, for
the branches the port runs:
  A. a LoRA dir over a base (a model name holding "lora", with
     `model_base`): the config from the LoRA dir, the projector and any
     trained embed / lm_head rows from its `non_lora_trainables.bin`, the
     peft adapter merged into the base decoder on the host with the dir's
     r / lora_alpha (builder.py:37-72), all before quantization;
  B. base + projector-only dir -> load mm_projector.bin over the base
     (builder.py:73-89);
  C. merged single path (jirvin16/TEOChat layout), with `load_8bit` (int8
     weight-only, standing in for bitsandbytes) or `load_int4` (packed w4a16)
     (builder.py:90-112);
  D. plain LM in bf16.

Sources are LOCAL directories holding HF-format weights (*.safetensors or
pytorch_model*.bin shards), config.json and a tokenizer; nothing is
downloaded. Shards are opened lazily and converted on the host
(checkpoint/convert_hf.py); a quantized decoder is quantized on the card a
few layers at a time (ops/quant.py::quantize_llama_params_host), so the
card never holds it in 16 bits. Returns (tokenizer, model, processor_dict,
context_len) for API parity.

`load_multi_lora` attaches N peft adapter dirs UNMERGED over a loaded
model's backbone (int8 / int4 included), stacked for per-request routing.

The train-time flow (reference train.py:961 + llava_arch.py:51): with
`allow_partial` a checkpoint without a projector or a tower loads anyway,
without those subtrees, and `initialize_vision_modules` attaches them from
`--image_tower` / `--pretrain_mm_mlp_adapter` or a fresh draw.

Not ported yet, and raising where asked for: the MPT backend (ROADMAP item
14); the vision-token machinery (`mm_use_im_patch_token`,
`mm_use_im_start_end`, a tokenizer whose length differs from the
embedding's rows, a LoRA dir whose vocab differs from its base's),
`quantize_vision` and the video processor (item 15).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from teochat_torch.checkpoint import convert_hf
from teochat_torch.config import (
    MptConfig,
    ProjectorConfig,
    TEOChatConfig,
    VisionConfig,
    llama_config_from_hf,
    mpt_config_from_hf,
    vision_config_from_hf,
)
from teochat_torch.data.processing import ImageProcessor
from teochat_torch.models.teochat import TEOChat
from teochat_torch.utils import resolve_device, tree_leaves_with_path, tree_map, unported


class _LazyStateDict(Mapping):
    """Key -> tensor mapping over an HF checkpoint dir, loaded ON DEMAND.

    A 7B fp16 checkpoint is ~13.5 GB; reading every shard into one dict
    before conversion would double the host's peak next to the stacked
    conversion output. Safetensors shards are read a tensor at a time
    through `safe_open`; torch .bin shards load once with `mmap=True`, so
    their storage stays file-backed and the OS pages weights in as the
    converters touch them. Only tensor HEADERS are parsed at construction.
    """

    def __init__(self, path: str):
        self._safe_files: Dict[str, str] = {}  # key -> .safetensors file
        self._bin_store: Dict[str, Any] = {}  # key -> mmap-backed tensor
        safes = sorted(glob.glob(os.path.join(path, "*.safetensors")))
        bins = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin"))) + sorted(
            glob.glob(os.path.join(path, "*.pt"))
        )
        if safes:
            from safetensors import safe_open

            for f in safes:
                with safe_open(f, framework="pt") as sf:
                    for k in sf.keys():
                        self._safe_files[k] = f
        elif bins:
            for f in bins:
                self._bin_store.update(_load_torch_file(f, mmap=True))
        else:
            raise FileNotFoundError(
                f"no weight files (*.safetensors / *.bin) in {path}"
            )

    def __getitem__(self, key: str):
        f = self._safe_files.get(key)
        if f is not None:
            from safetensors import safe_open

            with safe_open(f, framework="pt") as sf:
                return sf.get_tensor(key)
        return self._bin_store[key]

    def __iter__(self):
        yield from self._safe_files
        yield from self._bin_store

    def __len__(self) -> int:
        return len(self._safe_files) + len(self._bin_store)


def _load_state_dict(path: str) -> Mapping[str, Any]:
    """All weight shards of an HF checkpoint dir as a LAZY key -> tensor
    mapping (see _LazyStateDict)."""
    return _LazyStateDict(path)


def _load_torch_file(path: str, mmap: bool = False) -> Dict[str, Any]:
    if mmap:
        try:
            return torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        except RuntimeError:
            # mmap needs the zipfile serialization format; a legacy file
            # loads whole
            pass
    return torch.load(path, map_location="cpu", weights_only=True)


def load_config(model_path: str) -> TEOChatConfig:
    """Build a TEOChatConfig from an HF config.json (reference fields:
    mm_image_tower, mm_projector_type, mm_vision_select_layer, ...).

    Dispatches the LLM backend on the config shape: MPT/LlavaMPT configs
    carry d_model/n_layers (reference configuration_mpt.py), LLaMA carries
    hidden_size/num_hidden_layers."""
    with open(os.path.join(model_path, "config.json")) as f:
        hf = json.load(f)
    if "mpt" in str(hf.get("model_type", "")).lower() or "d_model" in hf:
        llm = mpt_config_from_hf(hf)
    else:
        llm = llama_config_from_hf(hf)
    vision = VisionConfig()  # production tower geometry (LanguageBind ViT-L/14)
    projector = ProjectorConfig(
        projector_type=hf.get("mm_projector_type", "mlp2x_gelu"),
        mm_hidden_size=hf.get("mm_hidden_size", vision.hidden_size),
        hidden_size=llm.hidden_size,
    )
    return TEOChatConfig(
        vision=vision,
        projector=projector,
        llm=llm,
        llm_backend="mpt" if isinstance(llm, MptConfig) else "llama",
        mm_vision_select_layer=hf.get("mm_vision_select_layer", -2),
        mm_vision_select_feature=hf.get("mm_vision_select_feature", "patch"),
        mm_use_im_start_end=hf.get("mm_use_im_start_end", False),
        # reference builder.py:140 defaults the flag TRUE when absent (and
        # train.py:1086 always writes it, default True)
        mm_use_im_patch_token=hf.get("mm_use_im_patch_token", True),
        image_aspect_ratio=hf.get("image_aspect_ratio", None),
        video_decode_backend=hf.get("video_decode_backend", "opencv"),
        tokenizer_padding_side=hf.get("tokenizer_padding_side", "right"),
        tokenizer_model_max_length=hf.get("tokenizer_model_max_length", 3072),
        max_sequence_length=hf.get("max_sequence_length", 2048),
    )


def _load_tokenizer(model_path: str):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(model_path, use_fast=True)


def _strip_prefix(sd: Dict[str, Any], prefixes=("base_model.model.",)) -> Dict[str, Any]:
    out = {}
    for k, v in sd.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
                break
        out[k] = v
    return out


class UnportedVideoProcessor:
    """The "video" entry of the processor dict: the port has no video
    processor yet (ROADMAP item 15), so using it raises."""

    def _raise(self, *args, **kwargs):
        raise NotImplementedError("the video processor is not ported yet (ROADMAP item 15)")

    preprocess = __call__ = _raise


def _vision_params(sd: Mapping[str, Any], cfg: TEOChatConfig,
                   vision_path: Optional[str], allow_partial: bool = False) -> Optional[Dict]:
    """The tower: a separate dir (LanguageBind_Image layout) or the weights
    embedded in the checkpoint (reference builder.py, JAX builder.py:479-497);
    None where neither has it and `allow_partial` is set."""
    if vision_path is not None:
        return convert_hf.convert_clip_vision(_load_state_dict(vision_path), cfg.vision)
    vt_names = [k for k in sd if "image_tower" in k or "vision_model" in k]
    prefix = next(
        (k.split("vision_model")[0] for k in vt_names if "vision_model.encoder" in k), None
    )
    if prefix is None:
        if allow_partial:
            return None
        raise FileNotFoundError(
            "vision tower weights not found; pass vision_path pointing at a "
            "LanguageBind_Image checkpoint dir"
        )
    return convert_hf.convert_clip_vision(
        {k: sd[k] for k in vt_names}, cfg.vision, prefix=prefix + "vision_model.",
    )


def _read_adapter(path: str) -> Optional[Tuple[Mapping[str, Any], Dict]]:
    """A peft dir's (adapter state dict, adapter_config.json), or None
    without an adapter_model.{safetensors,bin}."""
    for fname in ("adapter_model.safetensors", "adapter_model.bin"):
        f = os.path.join(path, fname)
        if os.path.exists(f):
            if fname.endswith(".safetensors"):
                from safetensors.torch import load_file

                adapter = load_file(f)
            else:
                adapter = _load_torch_file(f)
            break
    else:
        return None
    lora_cfg = {}
    cfg_file = os.path.join(path, "adapter_config.json")
    if os.path.exists(cfg_file):
        with open(cfg_file) as f:
            lora_cfg = json.load(f)
    return adapter, lora_cfg


def _apply_lora_dir(lora_path: str, llm_params: Dict, proj_keys: Dict,
                    cfg: TEOChatConfig) -> Tuple[Dict, Dict]:
    """Branch A on the host decoder (reference builder.py:37-72): the
    non-LoRA trainables (projector, trained embed / lm_head rows) when the
    dir has them, then the peft adapter merged with its r / lora_alpha.
    Returns (decoder, projector keys)."""
    n_rows = llm_params["embed_tokens"]["embedding"].shape[0]
    if cfg.llm.vocab_size != n_rows:
        raise unported(f"resizing the base's embeddings to the LoRA config's vocab "
                        f"({cfg.llm.vocab_size} against {n_rows} rows; vision_tokenizer)", 15)
    nlt_file = os.path.join(lora_path, "non_lora_trainables.bin")
    if os.path.exists(nlt_file):
        nlt = _strip_prefix(_load_torch_file(nlt_file))
        proj_keys = {k: v for k, v in nlt.items() if "mm_projector" in k} or proj_keys
        llm_params = dict(llm_params)
        emb_w = nlt.get("model.embed_tokens.weight")
        if emb_w is not None:  # reference train.py:196-199, keys_to_match 'embed_tokens'
            llm_params["embed_tokens"] = {"embedding": emb_w.detach().cpu()}
        head_w = nlt.get("lm_head.weight")
        if head_w is not None:
            llm_params["lm_head"] = {"kernel": head_w.detach().cpu().T.contiguous()}
    read = _read_adapter(lora_path)
    if read is not None:
        adapter, lora_cfg = read
        llm_params = convert_hf.merge_lora_into_llama(
            llm_params, adapter, cfg.llm, rank=lora_cfg.get("r"), alpha=lora_cfg.get("lora_alpha"))
    return llm_params, proj_keys


def load_pretrained_model(
    model_path: str,
    model_base: Optional[str] = None,
    model_name: Optional[str] = None,
    load_8bit: bool = False,
    load_4bit: bool = False,
    load_int4: bool = False,
    device=None,
    cache_dir: Optional[str] = None,
    vision_path: Optional[str] = None,
    allow_partial: bool = False,
    quantize_vision: bool = False,
    **kwargs,
) -> Tuple[Any, TEOChat, Dict[str, Any], int]:
    """Load tokenizer + TEOChat model + processors (reference builder.py:27)
    onto `device` (None = the card; raises without one)."""
    if model_name is None:
        from teochat_torch.mm_utils import get_model_name_from_path

        model_name = get_model_name_from_path(model_path)
    if load_4bit:
        raise NotImplementedError(
            "bitsandbytes nf4 is not used; use load_int4 (packed w4a16) or "
            "load_8bit (int8 weight-only)"
        )
    if "mpt" in model_name.lower():
        raise unported("the MPT backend", 14)
    if quantize_vision:
        raise unported("quantize_vision", 15)
    device = resolve_device(device)

    base_path = model_base if model_base is not None else model_path
    lora_path = model_path if "lora" in model_name.lower() and model_base is not None else None
    cfg = load_config(lora_path or base_path)
    if cfg.mm_use_im_patch_token or cfg.mm_use_im_start_end:
        raise unported("the vision-token machinery (mm_use_im_patch_token, "
                        "mm_use_im_start_end)", 15)
    sd = _load_state_dict(base_path)

    llm_params = convert_hf.convert_llama(sd, cfg.llm)
    proj_keys = {k: sd[k] for k in sd if "mm_projector" in k}
    if lora_path is not None:
        llm_params, proj_keys = _apply_lora_dir(lora_path, llm_params, proj_keys, cfg)
    elif model_base is not None:
        # branch B: projector-only checkpoint over a base LM
        proj_file = os.path.join(model_path, "mm_projector.bin")
        if os.path.exists(proj_file):
            proj_keys = _load_torch_file(proj_file)
    if not proj_keys and not allow_partial:
        raise ValueError(f"no mm_projector weights found for {model_path}")
    proj_params = convert_hf.convert_projector(proj_keys, cfg.projector) if proj_keys else None
    vision_params = _vision_params(sd, cfg, vision_path, allow_partial)

    tokenizer = _load_tokenizer(lora_path or base_path)
    n_rows = llm_params["embed_tokens"]["embedding"].shape[0]
    if len(tokenizer) != n_rows:
        raise unported(f"resizing the embeddings to the tokenizer ({len(tokenizer)} "
                        f"tokens, {n_rows} rows; vision_tokenizer)", 15)
    if cfg.llm.vocab_size != len(tokenizer):
        import dataclasses

        cfg = dataclasses.replace(
            cfg, llm=dataclasses.replace(cfg.llm, vocab_size=len(tokenizer))
        )

    dtype = torch.bfloat16

    def upload(tree):
        return tree_map(lambda t: t.to(device, dtype), tree)

    params = {k: upload(v) for k, v in (("vision", vision_params), ("projector", proj_params))
              if v is not None}
    del vision_params, proj_params
    if load_8bit or load_int4:
        # projections stream host -> device in layer chunks: uploading the
        # whole fp16 7B decoder before quantizing would hold 13.5 GB on the card
        from teochat_torch.ops.quant import quantize_llama_params_host

        embedding = llm_params["embed_tokens"]["embedding"]
        params["llm"] = quantize_llama_params_host(llm_params, int4=load_int4, device=device)
        params["llm"]["embed_tokens"]["embedding"] = embedding.to(device, dtype)
    else:
        params["llm"] = upload(llm_params)
    del llm_params, sd

    model = TEOChat(cfg, params, tokenizer=tokenizer)
    # processor geometry follows the tower (224 in production; tiny in tests)
    processor = {
        "image": ImageProcessor(size=cfg.vision.image_size),
        "video": UnportedVideoProcessor(),
    }
    return tokenizer, model, processor, cfg.max_sequence_length


def initialize_vision_modules(
    model_args,
    cfg: TEOChatConfig,
    params: Dict[str, Any],
    *,
    generator: Optional[torch.Generator] = None,
    device=None,
    dtype: torch.dtype = torch.bfloat16,
) -> Tuple[TEOChatConfig, Dict[str, Any]]:
    """Attach the vision tower + projector to a partially-loaded model
    (reference llava_arch.py:51-140, JAX builder.py:275-364).

    Records the tower and projector choices on the config (mm_projector_type,
    mm_vision_select_layer / feature, mm_hidden_size), loads the tower from
    the local dir `model_args.image_tower` (or `video_tower`) with that dir's
    own config.json, and takes the projector from
    `model_args.pretrain_mm_mlp_adapter` or draws it from `generator`.
    Subtrees already present are kept. The new leaves go to `device` (None:
    the device of the params, else the card) in `dtype`."""
    import dataclasses

    if device is None:
        device = next((x.device for _, x in tree_leaves_with_path(params)), None)
    device = resolve_device(device)
    tower = getattr(model_args, "image_tower", None) or getattr(model_args, "video_tower", None)
    params = dict(params)
    if "vision" not in params:
        if tower is None or not os.path.isdir(tower):
            raise FileNotFoundError(
                f"vision tower weights not in the checkpoint and --image_tower "
                f"({tower!r}) is not a local directory; nothing is downloaded"
            )
        tower_cfg_file = os.path.join(tower, "config.json")
        if os.path.exists(tower_cfg_file):
            with open(tower_cfg_file) as f:
                tower_hf = json.load(f)
            cfg = dataclasses.replace(
                cfg, vision=vision_config_from_hf(tower_hf.get("vision_config", tower_hf)))
        vision = convert_hf.convert_clip_vision(_load_state_dict(tower), cfg.vision)
        params["vision"] = tree_map(lambda t: t.to(device, dtype), vision)

    proj_cfg = dataclasses.replace(
        cfg.projector,
        projector_type=getattr(model_args, "mm_projector_type", cfg.projector.projector_type),
        mm_hidden_size=cfg.vision.hidden_size,  # llava_arch.py:102-110
        hidden_size=cfg.llm.hidden_size,
    )
    cfg = dataclasses.replace(
        cfg,
        projector=proj_cfg,
        mm_vision_select_layer=model_args.mm_vision_select_layer,
        mm_vision_select_feature=getattr(model_args, "mm_vision_select_feature", "patch"),
    )
    if "projector" not in params:
        if getattr(model_args, "pretrain_mm_mlp_adapter", None):
            pw = _load_torch_file(model_args.pretrain_mm_mlp_adapter)
            proj = convert_hf.convert_projector(
                {k: v for k, v in pw.items() if "mm_projector" in k}, proj_cfg)
            params["projector"] = tree_map(lambda t: t.to(device, dtype), proj)
        else:
            from teochat_torch.checkpoint.bridge import init_projector

            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            params["projector"] = init_projector(proj_cfg, generator, device, dtype)
    # the reference re-enables the projector's gradients here (llava_arch.py:
    # 115-118); in the port that is the train driver's trainable_filter
    return cfg, params


def load_multi_lora(model: TEOChat, adapter_dirs) -> TEOChat:
    """Attach N peft adapter dirs UNMERGED for multi-LoRA serving.

    Each dir's adapter_model.{safetensors,bin} becomes unmerged adapter
    leaves over the model's backbone (which may be int8 or int4: nothing is
    merged), and the N trees are stacked along an adapter axis, routed per
    request (BatchEngine.submit(..., adapter=i), TEOChat.generate(adapters=
    [...]); -1 is the base model). Returns a new TEOChat that shares every
    base tensor; only the rank-r adapter stacks are new, fp32 on the
    model's device."""
    from teochat_torch.train.lora import stack_lora_adapters

    if not adapter_dirs:
        raise ValueError("load_multi_lora needs at least one adapter dir")
    trees = []
    for d in adapter_dirs:
        read = _read_adapter(d)
        if read is None:
            raise FileNotFoundError(f"no adapter_model.* in {d}")
        adapter, lora_cfg = read
        trees.append(convert_hf.attach_lora_to_llama(
            model.params["llm"], adapter, model.cfg.llm,
            rank=lora_cfg.get("r"), alpha=lora_cfg.get("lora_alpha")))
    return TEOChat(model.cfg, {**model.params, "llm": stack_lora_adapters(trees)},
                   tokenizer=model.tokenizer)
