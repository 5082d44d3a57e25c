"""Image preprocessing: the LanguageBind image pipeline, torch-free (the
port's own copy of teochat_tpu/data/processing.py).

Reference pipeline (processing_image.py:15-25): ToTensor -> bicubic
Resize(shorter side 224) -> CenterCrop(224) -> Normalize(OpenAI CLIP mean/std).
`ImageProcessor.preprocess` returns numpy [N, 3, 224, 224] float32 by one of
two paths that give the same bytes:
- native (teochat_torch/native, C++ through ctypes): PIL's fixed-point
  bicubic, bit for bit, with the crop and normalize fused; taken when the
  library builds (g++);
- PIL: `Image.resize(BICUBIC)`, then numpy crop and normalize.

Pillow is imported only where it is needed: for a path, a PIL image or an
array that is not [h, w, 3] uint8. Such an array goes to the native library
as it is (`np.asarray(_to_pil(a))` is `a` for it), so a caller that hands
decoded uint8 frames needs no Pillow when the native library is there.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from teochat_torch.constants import (
    OPENAI_DATASET_MEAN,
    OPENAI_DATASET_STD,
    VISION_IMAGE_SIZE,
)


def _to_pil(image):
    from PIL import Image

    if isinstance(image, str):
        return Image.open(image).convert("RGB")
    if isinstance(image, Image.Image):
        return image.convert("RGB")
    if isinstance(image, np.ndarray):
        if image.dtype != np.uint8:
            image = np.clip(image * 255.0 if image.max() <= 1.0 else image, 0, 255).astype(np.uint8)
        return Image.fromarray(image).convert("RGB")
    raise TypeError(f"unsupported image type {type(image)}")


def _to_rgb_uint8(image) -> np.ndarray:
    """An [h, w, 3] uint8 frame: the array itself when it is one (no Pillow
    needed), else through PIL."""
    if (isinstance(image, np.ndarray) and image.dtype == np.uint8
            and image.ndim == 3 and image.shape[2] == 3):
        return image
    return np.asarray(_to_pil(image), np.uint8)


class ImageProcessor:
    """API-parity stand-in for LanguageBindImageProcessor (preprocess ->
    {'pixel_values': [N,3,H,W]})."""

    def __init__(self, size: int = VISION_IMAGE_SIZE,
                 mean: Sequence[float] = OPENAI_DATASET_MEAN,
                 std: Sequence[float] = OPENAI_DATASET_STD,
                 use_native: bool = True):
        self.size = size
        self.image_mean = tuple(mean)
        self.image_std = tuple(std)
        self.crop_size = {"height": size, "width": size}
        self.use_native = use_native

    def _transform_one(self, image) -> np.ndarray:
        from PIL import Image

        img = _to_pil(image)
        w, h = img.size
        # shorter side -> self.size, bicubic (reference Resize(224) semantics)
        if w <= h:
            new_w, new_h = self.size, max(int(round(h * self.size / w)), self.size)
        else:
            new_w, new_h = max(int(round(w * self.size / h)), self.size), self.size
        img = img.resize((new_w, new_h), Image.BICUBIC)
        # center crop
        left = (new_w - self.size) // 2
        top = (new_h - self.size) // 2
        img = img.crop((left, top, left + self.size, top + self.size))
        arr = np.asarray(img, np.float32) / 255.0  # [H, W, 3]
        arr = (arr - np.asarray(self.image_mean, np.float32)) / np.asarray(
            self.image_std, np.float32
        )
        return arr.transpose(2, 0, 1)  # [3, H, W]

    def preprocess(self, images, return_tensors: str = "np") -> Dict[str, np.ndarray]:
        if not isinstance(images, list):
            images = [images]
        if self.use_native:
            from teochat_torch import native

            if native.available():
                frames = [_to_rgb_uint8(im) for im in images]
                pixel_values = native.preprocess_batch(
                    frames, self.size, self.image_mean, self.image_std
                )
                return {"pixel_values": pixel_values}
        pixel_values = np.stack([self._transform_one(im) for im in images], axis=0)
        return {"pixel_values": pixel_values}

    def __call__(self, images=None, **kwargs):
        return self.preprocess(images)
