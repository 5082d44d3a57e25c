"""Misc host utilities (reference videollava/utils.py).

The port's own copy of what it needs of teochat_tpu/utils.py: `order_pick_k`
(random order-preserving subsample, reference utils.py:18-29).
`resolve_device` (the default device of its entry points),
`tree_leaves_with_path` (a params tree's leaves by path) and `tree_map`
are the port's own.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

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


def tree_leaves_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in the tree's order; None leaves are skipped."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [] if tree is None else [(prefix, tree)]
    out = []
    for key, sub in items:
        out += tree_leaves_with_path(sub, f"{prefix}/{key}" if prefix else str(key))
    return out


def tree_map(fn, tree):
    """A params tree (nested dicts and lists) with `fn` applied to each leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)
