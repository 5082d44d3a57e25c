"""Misc host utilities (reference videollava/utils.py).

The port's own copy of what it needs of teochat_tpu/utils.py: `order_pick_k`
(random order-preserving subsample, reference utils.py:18-29).
`resolve_device` is the port's own: the default device of its entry points.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def order_pick_k(lst: Sequence, k: int) -> Tuple[List, Optional[List[int]]]:
    """Randomly subsample ``k`` items from ``lst`` preserving original order.

    Returns ``(items, sorted_indices)``; indices are ``None`` when no subsampling
    happened (reference utils.py:18-29).
    """
    if len(lst) <= k:
        return list(lst), None
    scores = np.random.random(len(lst))
    index_sort = sorted(np.argsort(scores)[:k].tolist())
    return [lst[i] for i in index_sort], index_sort


def resolve_device(device=None):
    """The device an entry point works on: the card, unless the caller names
    another. `None` means "cuda" and raises when there is no card; the CPU is
    used only when it is asked for."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                "pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)
