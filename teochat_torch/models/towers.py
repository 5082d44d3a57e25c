"""Vision tower wrapper and builder dispatch (port of teochat_tpu/models/towers.py).

An API-parity layer over the one ViT in vit.py, in place of the reference's
tower classes (LanguageBindImageTower languagebind/__init__.py:94-173,
CLIPVisionTower clip_encoder.py:7-78) and its name-dispatched builder
(multimodal_encoder/builder.py:7-24). Only the CLIP image tower is ported:
the video, audio, depth and thermal towers raise (ROADMAP item 15).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from teochat_torch.config import VisionConfig
from teochat_torch.models import vit as vit_mod
from teochat_torch.utils import resolve_device

_UNPORTED_TOWERS = ("video", "audio", "depth", "thermal")


class VisionTower:
    """Frozen tower facade: __call__(frames) -> selected features.

    Mirrors LanguageBindImageTower's surface: `hidden_size`, `num_patches`,
    `select_layer`, `select_feature`, lazy `load_model()`, and a forward that
    takes [N, 3, H, W] frames.
    """

    def __init__(self, cfg: VisionConfig, params: Optional[Dict] = None,
                 select_layer: int = -2, select_feature: str = "patch"):
        self.cfg = cfg
        self.params = params
        self.select_layer = select_layer
        self.select_feature = select_feature
        self.is_loaded = params is not None

    # --- properties matching languagebind/__init__.py:167-173 ---
    @property
    def hidden_size(self) -> int:
        return self.cfg.hidden_size

    @property
    def num_patches(self) -> int:
        return self.cfg.num_patches

    def load_model(self, params: Optional[Dict] = None,
                   rng: Optional[torch.Generator] = None, device=None,
                   dtype: torch.dtype = torch.float32):
        """Attach weights: a converted checkpoint, or a random init drawn
        from `rng` (seed 0 when None) on `device` (None = the card)."""
        if params is not None:
            self.params = params
        elif self.params is None:
            from teochat_torch.checkpoint.bridge import _Init, _init_vit

            device = resolve_device(device)
            if rng is None:
                rng = torch.Generator(device=device).manual_seed(0)
            self.params = _init_vit(_Init(rng, device, dtype), self.cfg)
        self.is_loaded = True
        return self

    def _require_loaded(self) -> None:
        if not self.is_loaded:
            raise RuntimeError("tower not loaded; call load_model()")

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """[N, 3, H, W] -> [N, tokens, D] selected features (frames folded)."""
        self._require_loaded()
        hidden = vit_mod.vit_forward(
            self.params, self.cfg, images, select_layer=self.select_layer
        )
        return vit_mod.select_features(hidden, self.select_feature)

    def encode_videos(self, videos: torch.Tensor) -> torch.Tensor:
        """[B, T, 3, H, W] -> [B, T, tokens, D] (reference encode_videos
        llava_arch.py:142-146); an image tower encodes each frame alone."""
        self._require_loaded()
        b, t = videos.shape[:2]
        flat = videos.reshape((b * t,) + tuple(videos.shape[2:]))
        hidden = vit_mod.vit_forward(
            self.params, self.cfg, flat,
            select_layer=self.select_layer, num_frames=t,
        )
        feats = vit_mod.select_features(hidden, self.select_feature)
        return feats.reshape(b, t, feats.shape[1], feats.shape[2])


def build_vision_tower(
    tower_name: str,
    *,
    base_cfg: Optional[VisionConfig] = None,
    select_layer: int = -2,
    select_feature: str = "patch",
    **kwargs,
) -> VisionTower:
    """Name-dispatched tower construction (reference builder.py:7-16 +
    languagebind dispatch): *LanguageBind_Image* / openai/* / laion/* / clip
    names give the image tower."""
    cfg = base_cfg or VisionConfig()
    name = tower_name.lower()
    unported = next((k for k in _UNPORTED_TOWERS if k in name), None)
    if unported is not None:
        raise NotImplementedError(
            f"the {unported} tower ({tower_name}) is not ported yet (ROADMAP item 15)"
        )
    if not any(k in name for k in ("image", "openai", "laion", "clip")):
        raise ValueError(f"Unknown vision tower: {tower_name}")
    cfg = dataclasses.replace(cfg, add_time_attn=False)
    return VisionTower(cfg, select_layer=select_layer, select_feature=select_feature)


def build_video_tower(tower_name: str = "LanguageBind_Video_merge", **kwargs) -> VisionTower:
    """Reference multimodal_encoder/builder.py:18-24 equivalent."""
    return build_vision_tower(tower_name, **kwargs)
