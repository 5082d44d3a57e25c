"""Configuration tree for TEOChat (the port's own copy of teochat_tpu/config.py).

Field for field the JAX package's tree, so a config built for one backend
describes the same model on the other; fields of features the port does not
run yet are kept and rejected where they are read.

One frozen-dataclass config per subsystem, composed into `TEOChatConfig`. This
replaces the reference's three config mechanisms (HF config.json fields spread
across llava_arch.py:63-108, HfArgumentParser dataclasses train.py:48-120, and
DeepSpeed JSON) with a single serializable tree; `from_hf_dict` importers keep
checkpoint-compat with the reference's persisted config.json keys.
"""

from __future__ import annotations

import dataclasses
import json
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class VisionConfig:
    """CLIP ViT tower (reference: LanguageBind_Image ViT-L/14, modeling_image.py).

    One implementation parameterized by config replaces the reference's five
    near-identical vendored CLIP copies (SURVEY §2 M6). `add_time_attn` enables
    the per-layer temporal attention block of the video tower
    (modeling_video.py:105-134 behavior).
    """

    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    # Feature extraction for the LLaVA tower (reference languagebind/__init__.py:121-129)
    select_layer: int = -2
    select_feature: str = "patch"
    # Video-tower temporal attention (reference modeling_video.py:65-158)
    add_time_attn: bool = False
    num_frames: int = 8

    @property
    def grid(self):
        """(grid_h, grid_w); image_size may be an int (square towers) or an
        (H, W) tuple — the audio tower runs the same ViT over rectangular
        mel spectrograms (reference modeling_audio.py:798 sets
        image_size=[num_mel_bins, target_length])."""
        hw = self.image_size
        h, w = (hw, hw) if isinstance(hw, int) else hw
        return (h // self.patch_size, w // self.patch_size)

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid
        return gh * gw

    @property
    def num_positions(self) -> int:
        return self.num_patches + 1  # + CLS

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class ProjectorConfig:
    """Vision-language projector (reference multimodal_projector/builder.py:33-51)."""

    projector_type: str = "mlp2x_gelu"  # linear | mlp{N}x_gelu | identity
    mm_hidden_size: int = 1024
    hidden_size: int = 4096

    @property
    def depth(self) -> int:
        if self.projector_type == "linear":
            return 1
        m = re.match(r"^mlp(\d+)x_gelu$", self.projector_type)
        if m:
            return int(m.group(1))
        if self.projector_type == "identity":
            return 0
        raise ValueError(f"Unknown projector type: {self.projector_type}")


@dataclass(frozen=True)
class LlamaConfig:
    """LLaMA-2 decoder (production: 7B Vicuna v1.5 via Video-LLaVA-7B)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    bos_token_id: int = 1
    eos_token_id: int = 2
    pad_token_id: int = 0
    tie_word_embeddings: bool = False
    # w8a8 prefill: per-token int8 activations feed the int8 matrix units
    # for s>1 projections when the backbone is int8-quantized.
    # Off by default: metric-parity, not bit-parity (ops/quant.py).
    int8_prefill_activations: bool = False
    # Context parallelism: name of a mesh axis to shard the SEQUENCE over in
    # cache-free (training / teacher-forced) forwards — attention runs the
    # ppermute ring (parallel/ring_attention.py), everything else shards
    # positionally under GSPMD. Requires right-padded batches (causal-only
    # masking) and S divisible by the axis size (GQA grouping supported);
    # misconfiguration raises at trace time. None = off (parity needs
    # <=4.4k tokens; this is the beyond-reference long-context lever).
    sequence_axis: Optional[str] = None
    # Decode-time sequence sharding: name of a mesh axis to shard the KV
    # cache's TIME dimension over (parallel/sharded_cache.py). Cached
    # attention reads become per-shard online-softmax partials combined with
    # pmax/psum (O(B*H*D) ICI bytes per step, independent of context length);
    # cache writes stay GSPMD scatters. Cache length must divide the axis
    # size. None = off — the single-device cached path. Orthogonal to
    # `sequence_axis` (which covers cache-FREE forwards).
    cache_sequence_axis: Optional[str] = None
    # Pipeline parallelism: name of a mesh axis to shard the stacked LAYER
    # axis over in cache-free forwards (parallel/pipeline.py). Stage s holds
    # layers [s*L/P, (s+1)*L/P); activations rotate stage-to-stage via
    # ppermute in the GPipe microbatch schedule. num_layers must divide the
    # axis size; batch must divide pipeline_microbatches. Incompatible with
    # sequence_axis (would nest shard_maps). None = off.
    pipeline_axis: Optional[str] = None
    # Microbatch count for the pipeline schedule (None = stage count).
    # Bubble fraction is (P-1)/(M+P-1): more microbatches, less bubble.
    pipeline_microbatches: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class MptConfig:
    """MPT decoder variant (reference model/language_model/mpt/): ALiBi, no RoPE."""

    vocab_size: int = 50368
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    expansion_ratio: int = 4
    max_seq_len: int = 2048
    alibi_bias_max: int = 8
    # multiquery -> 1 kv head; torch-impl default is full MHA
    attn_type: str = "multihead_attention"  # or "multiquery_attention"
    no_bias: bool = True
    learned_pos_emb: bool = False
    logit_scale: Optional[float] = None
    # EleutherAI/gpt-neox-20b tokenizer (production MPT pairing): <|endoftext|>
    eos_token_id: int = 0
    pad_token_id: int = 0
    # pipeline parallelism over the stacked layer axis (parallel/pipeline.py),
    # same contract as LlamaConfig.pipeline_axis
    pipeline_axis: Optional[str] = None
    pipeline_microbatches: Optional[int] = None
    # decode-time cache sequence sharding: not implemented for MPT (the ALiBi
    # bias table would need per-shard offsets); kept for init_cache's contract
    cache_sequence_axis: Optional[str] = None
    # from-scratch init scheme (reference configuration_mpt.py:5 defaults,
    # param_init_fns.py registry); None keeps init_mpt's simple normal(0.02)
    init_config: Optional[dict] = None

    # llama.init_cache / generation.py cache-contract aliases
    @property
    def num_layers(self) -> int:
        return self.n_layers

    @property
    def num_kv_heads(self) -> int:
        return 1 if self.attn_type == "multiquery_attention" else self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def hidden_size(self) -> int:
        return self.d_model


@dataclass(frozen=True)
class GenerationConfig:
    """Decode-time knobs (reference eval defaults: eval.py:47-53, inference.py:64-72)."""

    max_new_tokens: int = 256
    temperature: float = 0.2
    do_sample: bool = True
    top_p: float = 1.0
    stop_strings: Tuple[str, ...] = ("</s>",)
    # Prompt-lookup speculation: verify this many drafted tokens per decode
    # step (0 = off). Greedy runs are token-identical to the plain path;
    # temperature/top-p sampling runs use exact speculative sampling
    # (distribution-identical, but randomness is consumed differently so
    # outputs are not seed-reproducible vs the plain path).
    speculative_k: int = 0
    # Bench/testing knob: corrupt each drafted token with prob (1 - p) before
    # verification, simulating a target acceptance rate (bench.py measures
    # the tok/s-vs-acceptance curve). None = production (draft verbatim).
    # Corruption never changes outputs — wrong drafts are simply rejected.
    speculative_draft_keep_prob: Optional[float] = None


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout: (data, fsdp, model) axes over ICI (SURVEY §2.4),
    plus optional `sequence` (context parallelism — LlamaConfig.sequence_axis
    / parallel/ring_attention.py) and `pipe` (pipeline parallelism —
    LlamaConfig.pipeline_axis / parallel/pipeline.py) axes, each only
    materialized when > 1."""

    data: int = 1
    fsdp: int = 1
    model: int = 1
    sequence: int = 1
    pipe: int = 1
    axis_names: Tuple[str, str, str] = ("data", "fsdp", "model")


@dataclass(frozen=True)
class TEOChatConfig:
    """Top-level model config: tower + projector + decoder + fusion knobs."""

    vision: VisionConfig = field(default_factory=VisionConfig)
    projector: ProjectorConfig = field(default_factory=ProjectorConfig)
    llm: LlamaConfig = field(default_factory=LlamaConfig)
    llm_backend: str = "llama"  # llama | mpt
    # Fusion knobs persisted by the reference into config.json (llava_arch.py:63-108)
    mm_vision_select_layer: int = -2
    mm_vision_select_feature: str = "patch"
    mm_use_im_start_end: bool = False
    mm_use_im_patch_token: bool = False
    image_aspect_ratio: Optional[str] = None
    tokenizer_padding_side: str = "right"
    tokenizer_model_max_length: int = 3072
    max_sequence_length: int = 2048
    # Video decoder library (reference processing_video.py:26-114:
    # opencv | decord | pytorchvideo); decord/pytorchvideo are optional
    # imports behind guards in data/processing_extra.VideoProcessor
    video_decode_backend: str = "opencv"
    # Runtime
    dtype: str = "bfloat16"
    quant: Optional[str] = None  # None | "int8"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "TEOChatConfig":
        d = json.loads(s)
        llm_d = {
            k: (tuple(v) if isinstance(v, list) else v)
            for k, v in d.pop("llm").items()
        }
        # backend dispatch: MPT checkpoints must round-trip auto-resume
        # (checkpoint/orbax_io.py) with their own config class
        llm_cls = (
            MptConfig
            if d.get("llm_backend") == "mpt" or "d_model" in llm_d
            else LlamaConfig
        )
        return TEOChatConfig(
            vision=VisionConfig(**d.pop("vision")),
            projector=ProjectorConfig(**d.pop("projector")),
            llm=llm_cls(**llm_d),
            **d,
        )


def tiny_test_config(
    vocab_size: int = 128,
    add_time_attn: bool = False,
) -> TEOChatConfig:
    """A tiny randomly-initializable config for CPU tests and parity checks."""
    vision = VisionConfig(
        image_size=28,
        patch_size=14,
        hidden_size=32,
        intermediate_size=64,
        num_layers=3,
        num_heads=4,
        add_time_attn=add_time_attn,
        num_frames=4,
    )
    llm = LlamaConfig(
        vocab_size=vocab_size,
        hidden_size=64,
        intermediate_size=128,
        num_layers=3,
        num_heads=4,
        num_kv_heads=4,
        max_position_embeddings=512,
    )
    projector = ProjectorConfig(mm_hidden_size=32, hidden_size=64)
    return TEOChatConfig(vision=vision, projector=projector, llm=llm)


def llama_config_from_hf(d: Dict[str, Any]) -> LlamaConfig:
    """Import an HF LLaMA config.json dict (checkpoint-compat path)."""
    return LlamaConfig(
        vocab_size=d["vocab_size"],
        hidden_size=d["hidden_size"],
        intermediate_size=d["intermediate_size"],
        num_layers=d["num_hidden_layers"],
        num_heads=d["num_attention_heads"],
        num_kv_heads=d.get("num_key_value_heads", d["num_attention_heads"]),
        rms_norm_eps=d.get("rms_norm_eps", 1e-5),
        rope_theta=d.get("rope_theta", 10000.0),
        max_position_embeddings=d.get("max_position_embeddings", 4096),
        bos_token_id=d.get("bos_token_id", 1),
        eos_token_id=d.get("eos_token_id", 2),
        pad_token_id=d.get("pad_token_id", 0) or 0,
        tie_word_embeddings=d.get("tie_word_embeddings", False),
    )


def mpt_config_from_hf(d: Dict[str, Any]) -> MptConfig:
    """Import an HF MPT / LlavaMPT config.json dict (reference
    configuration_mpt.py fields; attn_config nests the attention knobs)."""
    attn = d.get("attn_config", {}) or {}
    return MptConfig(
        vocab_size=d["vocab_size"],
        d_model=d["d_model"],
        n_layers=d["n_layers"],
        n_heads=d["n_heads"],
        expansion_ratio=d.get("expansion_ratio", 4),
        max_seq_len=d.get("max_seq_len", 2048),
        alibi_bias_max=attn.get("alibi_bias_max", 8),
        attn_type=attn.get("attn_type", "multihead_attention"),
        no_bias=d.get("no_bias", True),
        learned_pos_emb=d.get("learned_pos_emb", False),
        logit_scale=d.get("logit_scale"),
        eos_token_id=d.get("eos_token_id", 0) or 0,
        pad_token_id=d.get("pad_token_id", 0) or 0,
    )


def vision_config_from_hf(d: Dict[str, Any]) -> VisionConfig:
    """Import an HF CLIPVisionConfig dict (LanguageBind image tower layout)."""
    return VisionConfig(
        image_size=d.get("image_size", 224),
        patch_size=d.get("patch_size", 14),
        hidden_size=d.get("hidden_size", 1024),
        intermediate_size=d.get("intermediate_size", 4096),
        num_layers=d.get("num_hidden_layers", 24),
        num_heads=d.get("num_attention_heads", 16),
        layer_norm_eps=d.get("layer_norm_eps", 1e-5),
        hidden_act=d.get("hidden_act", "quick_gelu"),
        add_time_attn=d.get("add_time_attn", False),
        num_frames=d.get("num_frames", 8),
    )
