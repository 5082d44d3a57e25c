"""Multimodal fusion (port of teochat_tpu/models/fusion.py).

`build_fusion_plan` is host code: per row it expands each IMAGE_TOKEN_INDEX
sentinel into `tokens_per_frame` vision slots, truncates to `max_length`,
pads to `pad_to` and emits gather indices, as numpy arrays equal to the JAX
package's. It is kept here without JAX; a shared jax-free module in
`teochat_tpu` would replace this copy. `fuse` splices the vision tokens into
the text embeddings on the device. Frames are consumed in flat batch order,
and text-only rows consume no frame.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from teochat_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX


@dataclasses.dataclass
class FusionPlan:
    """Static-shape gather plan; numpy arrays [B, L] unless noted."""

    text_ids: np.ndarray  # [B, Lt] sentinel-free token ids (sentinels -> 0)
    text_gather: np.ndarray  # index into the text_ids row
    vis_gather: np.ndarray  # index into flat [N_frames * tokens_per_frame]
    is_vision: np.ndarray  # bool
    attention_mask: np.ndarray  # bool
    position_ids: np.ndarray  # int32
    labels: np.ndarray  # int32 (IGNORE_INDEX at vision/pad)
    seq_lens: np.ndarray  # [B] int32 fused lengths


def build_fusion_plan(
    input_ids: Sequence[Sequence[int]],
    *,
    labels: Optional[Sequence[Sequence[int]]] = None,
    tokens_per_frame: int = 256,
    max_length: int = 3072,
    pad_to: Optional[int] = None,
    image_token_index: int = IMAGE_TOKEN_INDEX,
) -> FusionPlan:
    """Build the gather plan on the host (see the module docstring)."""
    b = len(input_ids)
    rows = []
    frame_cursor = 0
    fused_lens = []
    for r in range(b):
        ids = list(input_ids[r])
        labs = list(labels[r]) if labels is not None else [0] * len(ids)
        if len(labs) != len(ids):
            raise ValueError(f"row {r}: labels length {len(labs)} != ids {len(ids)}")
        out = []  # (is_vision, text_pos_or_visflat, label)
        for text_pos, (tok, lab) in enumerate(zip(ids, labs)):
            if tok == image_token_index:
                base = frame_cursor * tokens_per_frame
                out.extend((True, base + t, IGNORE_INDEX) for t in range(tokens_per_frame))
                frame_cursor += 1
            else:
                out.append((False, text_pos, lab))
        out = out[:max_length]
        rows.append(out)
        fused_lens.append(len(out))

    L = pad_to if pad_to is not None else max(fused_lens) if fused_lens else 1
    if L < max(fused_lens, default=0):
        raise ValueError(f"pad_to={L} smaller than fused length {max(fused_lens)}")
    Lt = max((len(r) for r in input_ids), default=1)

    text_ids = np.zeros((b, Lt), np.int32)
    text_gather = np.zeros((b, L), np.int32)
    vis_gather = np.zeros((b, L), np.int32)
    is_vision = np.zeros((b, L), bool)
    attention_mask = np.zeros((b, L), bool)
    labels_out = np.full((b, L), IGNORE_INDEX, np.int32)
    for r in range(b):
        ids = list(input_ids[r])
        text_ids[r, : len(ids)] = [0 if t == image_token_index else t for t in ids]
        for pos, (isv, idx, lab) in enumerate(rows[r]):
            is_vision[r, pos] = isv
            (vis_gather if isv else text_gather)[r, pos] = idx
            labels_out[r, pos] = lab
        attention_mask[r, : fused_lens[r]] = True
    position_ids = np.where(
        attention_mask, np.cumsum(attention_mask, axis=1) - 1, 0
    ).astype(np.int32)
    return FusionPlan(
        text_ids=text_ids,
        text_gather=text_gather,
        vis_gather=vis_gather,
        is_vision=is_vision,
        attention_mask=attention_mask,
        position_ids=position_ids,
        labels=labels_out,
        seq_lens=np.asarray(fused_lens, np.int32),
    )


def fuse(
    text_embeds: torch.Tensor,  # [B, Lt, D]
    vision_tokens: torch.Tensor,  # [N_frames, tokens_per_frame, D], flat batch order
    plan: FusionPlan,
) -> torch.Tensor:
    """Splice vision tokens into the embedding sequence. Returns [B, L, D]."""
    dev = text_embeds.device
    d = text_embeds.shape[-1]
    text_gather = torch.as_tensor(plan.text_gather, dtype=torch.long, device=dev)
    vis_gather = torch.as_tensor(plan.vis_gather, dtype=torch.long, device=dev)
    is_vision = torch.as_tensor(plan.is_vision, device=dev)
    from_text = torch.gather(
        text_embeds, 1, text_gather[:, :, None].expand(-1, -1, d)
    )
    from_vis = vision_tokens.reshape(-1, d)[vis_gather]
    return torch.where(is_vision[:, :, None], from_vis.to(from_text.dtype), from_text)


def count_frames(input_ids: Sequence[Sequence[int]],
                 image_token_index: int = IMAGE_TOKEN_INDEX) -> int:
    return sum(sum(1 for t in row if t == image_token_index) for row in input_ids)
