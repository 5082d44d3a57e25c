"""Image loading for the data path (the part of teochat_tpu/data/processing.py
that the port's dataset needs).

`_to_pil` turns a path, a PIL image or an array into an RGB PIL image.
Pillow is imported inside the function: the machine with the card may not
have it, and a run that never pads frames to a square never needs it. The
JAX package's `ImageProcessor` (PIL / C++ / Pallas resize) is not ported;
callers pass their own processor object.
"""

from __future__ import annotations

import numpy as np


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
