"""Vision tower wrapper and builder dispatch (port of teochat_tpu/models/towers.py).

An API-parity layer over the one ViT in vit.py, in place of the reference's
tower classes (LanguageBindImageTower languagebind/__init__.py:94-173,
CLIPVisionTower clip_encoder.py:7-78) and its name-dispatched builder
(multimodal_encoder/builder.py:7-24). One implementation, five modality
surfaces: the video tower is the image tower with `add_time_attn` (the
temporal attention over the frame axis); the audio tower runs the same
stack over rectangular mel spectrograms; depth and thermal reuse the image
geometry (their processors differ: data/processing_extra.py).
`tower_config` is the one place a tower name is read: the builder takes
its geometry from it (`load_config` for a checkpoint's `mm_image_tower`,
`initialize_vision_modules` for `--image_tower` / `--video_tower`), so an
unknown name raises and a video or audio tower loads with its own
geometry. `TEOChat.encode` then runs `vit.py` on that config; the
`VisionTower` facade is the reference's API by tower name over the same
function.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from teochat_torch.config import VisionConfig
from teochat_torch.models import vit as vit_mod
from teochat_torch.utils import resolve_device

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
        llava_arch.py:142-146): a video tower's temporal attention runs over
        the T axis; an image tower encodes each frame alone."""
        self._require_loaded()
        b, t = videos.shape[:2]
        flat = videos.reshape((b * t,) + tuple(videos.shape[2:]))
        hidden = vit_mod.vit_forward(
            self.params, self.cfg, flat,
            select_layer=self.select_layer, num_frames=t,
        )
        feats = vit_mod.select_features(hidden, self.select_feature)
        return feats.reshape(b, t, feats.shape[1], feats.shape[2])


def tower_config(tower_name: str, base_cfg: Optional[VisionConfig] = None,
                 num_mel_bins: int = 126, target_length: int = 1036) -> VisionConfig:
    """The tower geometry a name selects (reference builder.py:7-16 +
    languagebind dispatch), every name onto the one ViT of `base_cfg`
    (the production ViT-L/14 when None):

    - *Video* -> the temporal-attention tower (add_time_attn);
    - *Audio* -> rectangular spectrograms, image_size (num_mel_bins,
      target_length), LanguageBind's 126 x 1036 by default: 9 x 74 patches
      at p 14 (reference modeling_audio.py:795-846);
    - *Image* / openai/* / laion/* / clip / depth / thermal -> the image tower.
    Any other name raises ValueError."""
    cfg = base_cfg or VisionConfig()
    name = tower_name.lower()
    if "video" in name:
        return dataclasses.replace(cfg, add_time_attn=True)
    if "audio" in name:
        return dataclasses.replace(cfg, add_time_attn=False,
                                   image_size=(num_mel_bins, target_length))
    if any(k in name for k in ("image", "openai", "laion", "depth", "thermal", "clip")):
        return dataclasses.replace(cfg, add_time_attn=False)
    raise ValueError(f"Unknown vision tower: {tower_name}")


def build_vision_tower(
    tower_name: str,
    *,
    base_cfg: Optional[VisionConfig] = None,
    select_layer: int = -2,
    select_feature: str = "patch",
    **kwargs,
) -> VisionTower:
    """Name-dispatched tower construction: `tower_config`'s geometry
    (`kwargs`: the audio tower's num_mel_bins / target_length), weights
    attached by `load_model`."""
    return VisionTower(tower_config(tower_name, base_cfg, **kwargs),
                       select_layer=select_layer, select_feature=select_feature)


def build_video_tower(tower_name: str = "LanguageBind_Video_merge", **kwargs) -> VisionTower:
    """Reference multimodal_encoder/builder.py:18-24 equivalent."""
    return build_vision_tower(tower_name, **kwargs)
