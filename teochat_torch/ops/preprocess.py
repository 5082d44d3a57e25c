"""Device-side batched image preprocessing (port of teochat_tpu/ops/preprocess.py).

The host pipeline (data/processing.py, native/) mirrors the reference
transform byte for byte; this module is the device path: decoded uint8
frames go to the card once, and the resize, crop and normalization run
there as two matrix products and elementwise torch ops (XLA ops on the JAX
side, not a Pallas kernel).

The resize is `jax.image.resize(method="bicubic")`'s: Keys' cubic with
a = -0.5, its support widened by 1 / scale where it downsamples (an
antialiasing filter), each output's weights renormalized to sum to 1, and an
output whose sample falls outside the input weighted 0. Neither of
`F.interpolate`'s bicubic forms is that filter (a = -0.75 without
antialias; PIL's with it), so the separable weights are built on the host
with JAX's formula, the centre crop taken as rows of them, and applied as
`W_h x W_w^T`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from teochat_torch.constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD, VISION_IMAGE_SIZE


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel at a = -0.5, for x >= 0 (fp32 in, fp32 out)."""
    f32 = np.float32
    out = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    out = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), out)
    return np.where(x >= 2.0, f32(0.0), out)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] fp32 weights of JAX's bicubic resize along one
    axis (`jax._src.image.scale.compute_weight_mat`, transposed), in its
    fp32 arithmetic."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))  # antialias: widen the kernel when downsampling
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    w = _keys_cubic(np.abs(sample[:, None] - np.arange(in_size, dtype=f32)[None, :])
                    / kernel_scale).astype(f32)
    total = w.sum(axis=1, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], w, f32(0.0)).astype(f32)


def _resized_shape(h: int, w: int, size: int):
    """The shorter side to `size`, the other by the aspect ratio (at least
    `size`): (new_h, new_w), the reference transform's rule."""
    if w <= h:
        return max(int(round(h * size / w)), size), size
    return size, max(int(round(w * size / h)), size)


@functools.lru_cache(maxsize=16)
def crop_weights(h: int, w: int, size: int, device: str):
    """(W_h [size, h], W_w [size, w]) fp32 on `device`: the resize to the
    shorter side's `size`, then the centre crop of size x size, as rows of
    each axis's weights."""
    new_h, new_w = _resized_shape(h, w, size)
    top, left = (new_h - size) // 2, (new_w - size) // 2
    wh = resize_weights(h, new_h)[top:top + size]
    ww = resize_weights(w, new_w)[left:left + size]
    return tuple(torch.from_numpy(np.ascontiguousarray(m)).to(device) for m in (wh, ww))


def preprocess_frames(frames_u8: torch.Tensor, size: int = VISION_IMAGE_SIZE) -> torch.Tensor:
    """[N, H, W, 3] uint8 -> [N, 3, size, size] float32, CLIP-normalized and
    clipped to +-10, on the frames' device: the reference transform's order
    (scale, bicubic shorter-side resize, centre crop, normalize) with the
    resize and the crop as one product on each axis."""
    _, h, w, _ = frames_u8.shape
    wh, ww = crop_weights(h, w, size, str(frames_u8.device))
    x = frames_u8.permute(0, 3, 1, 2).float() / 255.0  # [N, 3, H, W]
    x = torch.matmul(torch.matmul(wh, x), ww.T)  # [N, 3, size, size]
    mean = torch.tensor(OPENAI_DATASET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(OPENAI_DATASET_STD, dtype=torch.float32, device=x.device)
    x = (x - mean[:, None, None]) / std[:, None, None]
    return x.clamp(-10.0, 10.0)
