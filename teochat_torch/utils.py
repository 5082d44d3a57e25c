"""Misc host utilities (reference videollava/utils.py).

The port's own copy of what it needs of teochat_tpu/utils.py: `order_pick_k`
(random order-preserving subsample, reference utils.py:18-29), `rank0_print`
and `profile_trace` (a `torch.profiler` trace in place of JAX's).
`resolve_device` (the default device of its entry points), `unported`
(the error of what is not ported yet),
`tree_leaves_with_path` (a params tree's leaves by path), `tree_map` and
`tree_map_with_path` are the port's own.
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


def unported(what: str, item: int) -> NotImplementedError:
    """The error raised for what the port does not have yet, naming its
    ROADMAP.md item."""
    return NotImplementedError(f"{what} is not ported yet (ROADMAP item {item})")


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


def tree_map_with_path(fn, tree, prefix: str = ""):
    """A params tree with `fn(path, leaf)` applied to each leaf; dicts and
    lists are the tree's nodes, anything else (a tuple too) a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def is_rank0() -> bool:
    """Whether this process is rank 0 of an initialized torch.distributed
    group, or the one process of a run without one."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def rank0_print(*args, **kwargs) -> None:
    """Print only on rank 0 (reference train.py:43-45): the rank of an
    initialized torch.distributed group, else this one process."""
    if is_rank0():
        print(*args, **kwargs)


class profile_trace:
    """A `torch.profiler` trace of the block, CPU and CUDA activity, written
    into `profile_dir` as a Chrome / Perfetto trace (`trace.json`) when the
    block ends (the JAX driver's --profile_dir). No-op when `profile_dir` is
    None."""

    def __init__(self, profile_dir):
        self.profile_dir = profile_dir
        self._prof = None

    def __enter__(self):
        if self.profile_dir:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            import os

            self._prof.__exit__(*exc)
            os.makedirs(self.profile_dir, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(self.profile_dir, "trace.json"))
            self._prof = None
        return False
