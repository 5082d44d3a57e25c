"""Train step and optimizer (port of teochat_tpu/train/trainer.py).

The params tree keeps the JAX layout (nested dicts and lists of tensors);
a leaf's path is its keys and list indices joined by '/', as
`teochat_tpu.parallel.sharding._path_str` writes it, so the same
`trainable_filter` predicates apply. Gradients are taken only for the
trainable leaves (the int8 backbone is not differentiable) and optimizer
moments exist only for them.

`make_optimizer` rebuilds the optax chain of the JAX package with the same
arithmetic, so both give the same parameters step for step:
- `clip_by_global_norm(max)`: over the whole trainable tree, before the
  groups, scale by max/norm only when norm >= max (no epsilon, unlike
  `torch.nn.utils.clip_grad_norm_`);
- `adamw` per group (eps 1e-8, eps_root 0, decoupled weight decay), the
  projector in its own group with its own schedule when `projector_lr` is set;
- schedules evaluated at the update count BEFORE it is incremented, so with
  warmup the first update has lr 0;
- `MultiSteps(k)`: the running mean of k micro-gradients, one inner update
  per k calls.
Unlike optax, which is functional, the update runs in place on the
parameters and moments (no second copy of either).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from teochat_torch.config import TEOChatConfig
from teochat_torch.models import fusion as fusion_mod
from teochat_torch.models import teochat as teochat_mod
from teochat_torch.parallel.tensor_parallel import local_tensor
from teochat_torch.utils import tree_leaves_with_path, tree_map

Schedule = Callable[[int], float]


class TrainState(NamedTuple):
    params: Dict
    opt_state: Any
    step: int  # train_step calls (micro-batches under accumulation)


def _tree_map_with_path(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def partition_params(params: Dict, trainable_filter) -> Tuple[Dict, Dict]:
    """Split params into (trainable, frozen) trees of the same structure,
    with None at the complementary leaves."""
    trainable = _tree_map_with_path(lambda p, x: x if trainable_filter(p) else None, params)
    frozen = _tree_map_with_path(lambda p, x: None if trainable_filter(p) else x, params)
    return trainable, frozen


# ---------------------------------------------------------------- schedules


def _linear(init: float, end: float, steps: int) -> Schedule:  # optax.linear_schedule
    def fn(count):
        c = min(max(count, 0), steps)
        return (init - end) * (1 - c / steps) + end

    return fn


def _cosine(init: float, decay_steps: int) -> Schedule:  # optax.cosine_decay_schedule
    if not decay_steps > 0:
        raise ValueError(f"the cosine schedule needs positive decay_steps, got {decay_steps}")

    def fn(count):
        c = min(count, decay_steps)
        return init * 0.5 * (1 + math.cos(math.pi * c / decay_steps))

    return fn


def _join(schedules, boundary: int) -> Schedule:  # optax.join_schedules, one boundary
    first, second = schedules
    return lambda count: first(count) if count < boundary else second(count - boundary)


def make_schedule(lr: float, lr_scheduler_type: str, total_steps: int,
                  warmup_ratio: float = 0.03, warmup_steps: int = 0) -> Schedule:
    """The lr at each update count, as teochat_tpu's make_optimizer builds it
    (HF SchedulerType names: cosine | linear | constant | constant_with_warmup)."""
    warmup = warmup_steps or max(int(total_steps * warmup_ratio), 1)
    if lr_scheduler_type == "cosine":
        return _join([_linear(0.0, lr, warmup), _cosine(lr, total_steps - warmup)], warmup)
    if lr_scheduler_type == "linear":
        return _join([_linear(0.0, lr, warmup),
                      _linear(lr, 0.0, max(total_steps - warmup, 1))], warmup)
    if lr_scheduler_type == "constant":
        return lambda count: lr
    if lr_scheduler_type == "constant_with_warmup":
        return _join([_linear(0.0, lr, warmup), lambda count: lr], warmup)
    raise ValueError(f"unsupported lr_scheduler_type: {lr_scheduler_type}")


# ---------------------------------------------------------------- optimizer


def _group_of(path: str) -> str:
    return "projector" if "projector" in path.split("/") else "base"


class AdamW:
    """Global-norm clip, then AdamW per group (optax.chain(clip_by_global_norm,
    multi_transform({'base': adamw, 'projector': adamw}))). `step` updates the
    params and the state in place."""

    def __init__(self, schedules: Dict[str, Schedule], *, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 max_grad_norm: Optional[float] = 1.0):
        self.schedules = schedules
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm

    def _label(self, path: str) -> str:
        return _group_of(path) if len(self.schedules) > 1 else "base"

    def init(self, trainable: Dict) -> Dict:
        leaves = tree_leaves_with_path(trainable)
        return {
            "count": {label: 0 for label in self.schedules},
            "mu": {p: torch.zeros_like(x) for p, x in leaves},
            "nu": {p: torch.zeros_like(x) for p, x in leaves},
        }

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             state: Dict, sq_norm=None) -> None:
        """One update in place. `sq_norm(grads)`, where given, is the squared
        global norm the clip reads (on a mesh: the shards' sums, each leaf
        counted once, summed over the ranks)."""
        if self.max_grad_norm and self.max_grad_norm > 0:
            if sq_norm is None:
                norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads.values()))
            else:
                norm = torch.sqrt(sq_norm(grads))
            keep = norm < self.max_grad_norm
            grads = {p: torch.where(keep, g, (g / norm.to(g.dtype)) * self.max_grad_norm)
                     for p, g in grads.items()}
        b1, b2 = self.b1, self.b2
        counts = state["count"]
        for path, g in grads.items():
            label = self._label(path)
            count = counts[label] + 1
            mu, nu = state["mu"][path], state["nu"][path]
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * (g * g))
            # optax's bias corrections are float32: 1 - decay ** count
            bc1 = float(1 - np.float32(b1) ** np.int32(count))
            bc2 = float(1 - np.float32(b2) ** np.int32(count))
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                update = update + self.weight_decay * params[path]
            params[path].add_(-self.schedules[label](counts[label]) * update)
        for label in counts:
            counts[label] += 1


class MultiSteps:
    """optax.MultiSteps: average k micro-gradients (running mean), apply the
    inner optimizer once per k calls."""

    def __init__(self, inner: AdamW, every_k: int):
        self.inner, self.every_k = inner, every_k

    def init(self, trainable: Dict) -> Dict:
        leaves = tree_leaves_with_path(trainable)
        return {"inner": self.inner.init(trainable), "mini_step": 0,
                "acc": {p: torch.zeros_like(x) for p, x in leaves}}

    @torch.no_grad()
    def step(self, params, grads, state, sq_norm=None) -> None:
        n = state["mini_step"]
        for path, g in grads.items():
            acc = state["acc"][path]
            acc.add_((g - acc) / (n + 1))
        if n == self.every_k - 1:
            self.inner.step(params, state["acc"], state["inner"], sq_norm)
            for acc in state["acc"].values():
                acc.zero_()
        state["mini_step"] = (n + 1) % self.every_k


def make_optimizer(
    learning_rate: float = 2e-4,
    *,
    projector_lr: Optional[float] = None,
    warmup_ratio: float = 0.03,
    total_steps: int = 10000,
    weight_decay: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    lr_scheduler_type: str = "cosine",
    max_grad_norm: Optional[float] = 1.0,
    warmup_steps: int = 0,
) -> AdamW:
    """AdamW + warmup + decay schedule with the separate projector group
    (teochat_tpu make_optimizer, the reference's llava_trainer groups)."""

    def schedule(lr):
        return make_schedule(lr, lr_scheduler_type, total_steps, warmup_ratio, warmup_steps)

    schedules = {"base": schedule(learning_rate)}
    if projector_lr is not None:
        schedules["projector"] = schedule(projector_lr)
    return AdamW(schedules, b1=b1, b2=b2, weight_decay=weight_decay,
                 max_grad_norm=max_grad_norm)


def _trainable_leaves(params: Dict, trainable_filter) -> Dict[str, torch.Tensor]:
    leaves = {p: x for p, x in tree_leaves_with_path(params)
              if trainable_filter is None or trainable_filter(p)}
    for path, x in leaves.items():
        if not x.is_floating_point():
            raise ValueError(f"trainable leaf {path} is {x.dtype}, not differentiable")
    return leaves


def fp32_masters(params: Dict, trainable_filter) -> Dict:
    """The params tree with each trainable floating leaf (every one without a
    filter) replaced by an fp32 copy (the master weights the optimizer
    updates in place; the forward casts them to the activation dtype). A
    bf16 master would round Adam's small steps away. The frozen leaves are
    shared, and the caller's trainable leaves are never written. An integer
    leaf the filter selects is left as it is: the train step refuses it."""

    def master(p, x):
        if (trainable_filter is None or trainable_filter(p)) and x.is_floating_point():
            return x.detach().to(torch.float32, copy=True)
        return x

    return _tree_map_with_path(master, params)


def init_train_state(params: Dict, optimizer, trainable_filter=None) -> TrainState:
    """Optimizer state over the trainable subtree only (all leaves without a
    filter). On a mesh (DTensor leaves) the moments are plain tensors the
    shape of each leaf's local shard."""
    trainable = params if trainable_filter is None else partition_params(
        params, trainable_filter)[0]
    trainable = tree_map(local_tensor, trainable)
    return TrainState(params=params, opt_state=optimizer.init(trainable), step=0)


def make_train_step(cfg: TEOChatConfig, optimizer, *, trainable_filter=None,
                    remat: bool = False, sharded=None) -> Callable:
    """train_step(state, plan, pixel_values) -> (state, loss).

    Gradients flow only to the leaves `trainable_filter(path)` accepts; the
    optimizer updates them in place. `remat` recomputes decoder layers in
    the backward (HF gradient checkpointing).

    With `sharded` (parallel/tensor_parallel.py::Sharded) the state's params
    are DTensors and `plan` / `pixel_values` this rank's rows: the forward
    runs on the local shards, each gradient is summed over the ranks that
    hold other rows, the clip reads the global norm, AdamW updates the
    local shards and their moments in place, and the loss returned is the
    global batch's (the same on every rank)."""

    def train_step(state: TrainState, plan: fusion_mod.FusionPlan,
                   pixel_values: torch.Tensor) -> Tuple[TrainState, torch.Tensor]:
        params = state.params if sharded is None else sharded.local(state.params)
        leaves = _trainable_leaves(params, trainable_filter)
        for x in leaves.values():
            x.requires_grad_(True)
        loss = teochat_mod.forward_train(params, cfg, plan, pixel_values, remat=remat,
                                         sharded=sharded)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {p: torch.zeros_like(x) if g is None else g
                 for (p, x), g in zip(leaves.items(), grads)}
        if sharded is None:
            optimizer.step(leaves, grads, state.opt_state)
        else:
            optimizer.step(leaves, sharded.reduce_grads(grads), state.opt_state,
                           sq_norm=sharded.global_sq_norm)
            loss = sharded.sum_rows(loss)
        return TrainState(state.params, state.opt_state, state.step + 1), loss.detach()

    return train_step
