"""Tokenizer/image utilities for the multimodal prompt contract.

Behavior-parity rebuild of reference videollava/mm_utils.py (tokenizer_image_token
:43-62, expand2square :14-25, process_images :28-40, KeywordsStoppingCriteria
:73-104, get_model_name_from_path :65-70): sequences are Python lists or
numpy arrays. The port's own copy of teochat_tpu/mm_utils.py.
"""

from __future__ import annotations

import base64
from io import BytesIO
from typing import List, Optional, Sequence

import numpy as np

from teochat_torch.constants import IMAGE_TOKEN_INDEX


def load_image_from_base64(image: str):
    from PIL import Image

    return Image.open(BytesIO(base64.b64decode(image)))


def expand2square(pil_img, background_color):
    """Pad a PIL image to a centered square (reference mm_utils.py:14-25)."""
    width, height = pil_img.size
    if width == height:
        return pil_img
    from PIL import Image

    side = max(width, height)
    result = Image.new(pil_img.mode, (side, side), background_color)
    if width > height:
        result.paste(pil_img, (0, (side - height) // 2))
    else:
        result.paste(pil_img, ((side - width) // 2, 0))
    return result


def process_images(images, image_processor, model_cfg) -> np.ndarray:
    """Preprocess a list of PIL images to a stacked [N,3,H,W] float array.

    Mirrors reference mm_utils.py:28-40 with numpy instead of torch tensors.
    """
    image_aspect_ratio = getattr(model_cfg, "image_aspect_ratio", None)
    if image_aspect_ratio == "pad":
        background = tuple(int(x * 255) for x in image_processor.image_mean)
        processed = [
            image_processor.preprocess(expand2square(im, background))["pixel_values"][0]
            for im in images
        ]
        return np.stack(processed, axis=0)
    return image_processor.preprocess(images)["pixel_values"]


def tokenizer_image_token(
    prompt: str,
    tokenizer,
    image_token_index: int = IMAGE_TOKEN_INDEX,
    return_tensors: Optional[str] = None,
):
    """Tokenize a prompt containing ``<image>`` tags into ids with sentinel indices.

    Splits on ``<image>``, tokenizes each chunk, and interleaves the sentinel id
    (-200) between chunks; a leading BOS (if the tokenizer emits one) is kept
    exactly once at the front (reference mm_utils.py:43-62).
    """
    prompt_chunks: List[List[int]] = [
        list(tokenizer(chunk).input_ids) for chunk in prompt.split("<image>")
    ]

    input_ids: List[int] = []
    offset = 0
    bos = getattr(tokenizer, "bos_token_id", None)
    if prompt_chunks and prompt_chunks[0] and bos is not None and prompt_chunks[0][0] == bos:
        offset = 1
        input_ids.append(prompt_chunks[0][0])

    sep = [image_token_index] * (offset + 1)
    for i, chunk in enumerate(prompt_chunks):
        if i > 0:
            input_ids.extend(sep[offset:])
        input_ids.extend(chunk[offset:])

    if return_tensors is None:
        return input_ids
    if return_tensors == "np":
        return np.asarray(input_ids, dtype=np.int64)
    if return_tensors == "pt":
        import torch

        return torch.tensor(input_ids, dtype=torch.long)
    raise ValueError(f"Unsupported tensor type: {return_tensors}")


def get_model_name_from_path(model_path: str) -> str:
    """Derive a model name from its path (reference mm_utils.py:65-70)."""
    model_path = model_path.strip("/")
    parts = model_path.split("/")
    if parts[-1].startswith("checkpoint-"):
        return parts[-2] + "_" + parts[-1]
    return parts[-1]


class KeywordsStoppingCriteria:
    """Stop generation when any keyword appears in the generated suffix.

    Torch-free rebuild of reference mm_utils.py:73-104: exact-id suffix match
    against each keyword's token ids, plus a decoded-substring fallback. The
    device decode loop uses only the id-suffix match (static-shape friendly);
    this class is the host-side API-parity wrapper.
    """

    def __init__(self, keywords: Sequence[str], tokenizer, input_ids):
        self.keywords = list(keywords)
        self.tokenizer = tokenizer
        self.keyword_ids: List[np.ndarray] = []
        self.max_keyword_len = 0
        bos = getattr(tokenizer, "bos_token_id", None)
        for keyword in self.keywords:
            ids = list(tokenizer(keyword).input_ids)
            if len(ids) > 1 and bos is not None and ids[0] == bos:
                ids = ids[1:]
            self.max_keyword_len = max(self.max_keyword_len, len(ids))
            self.keyword_ids.append(np.asarray(ids, dtype=np.int64))
        input_ids = np.asarray(input_ids)
        self.start_len = int(input_ids.shape[-1])

    def call_for_batch(self, output_ids, scores=None, **kwargs) -> bool:
        output_ids = np.asarray(output_ids)
        if output_ids.ndim == 1:
            output_ids = output_ids[None, :]
        offset = min(output_ids.shape[1] - self.start_len, self.max_keyword_len)
        for keyword_id in self.keyword_ids:
            k = keyword_id.shape[0]
            if output_ids.shape[1] >= k and np.array_equal(output_ids[0, -k:], keyword_id):
                return True
        if offset > 0:
            decoded = self.tokenizer.batch_decode(
                output_ids[:, -offset:], skip_special_tokens=True
            )[0]
            return any(keyword in decoded for keyword in self.keywords)
        return False

    def __call__(self, output_ids, scores=None, **kwargs) -> bool:
        output_ids = np.asarray(output_ids)
        if output_ids.ndim == 1:
            output_ids = output_ids[None, :]
        return all(
            self.call_for_batch(output_ids[i : i + 1], scores)
            for i in range(output_ids.shape[0])
        )
