"""GPipe pipeline parallelism over a `pipe` axis (port of
teochat_tpu/parallel/pipeline.py).

Every decoder layer leaf carries a leading [L, ...] axis, and on a mesh
with a `pipe` axis of P the sharding rules split it there
(parallel/sharding.py): stage s holds layers [s L/P, (s+1) L/P). The batch
is split into M microbatches; stage 0 takes each from the input, every
later stage receives it from the stage before, runs its layers and sends
it on. The activations move between neighbours through `exchange`
(parallel/tensor_parallel.py: NCCL, or gloo through pinned host buffers
on CUDA tensors).

`pipelined_scan_blocks` is one autograd Function, `_Pipeline`:
- forward: each stage runs its microbatches in order, each under its own
  graph (its input detached), and the last stage's results go to every
  pipe rank by a broadcast, as JAX's `psum` of the last stage's buffer
  does. JAX's schedule runs M + P - 1 steps in which the fill and drain
  compute on zeros it then discards; here a stage only ever runs the
  microbatches it owns, so those steps are skipped and nothing changes;
- backward: the microbatches in reverse order, each one's gradient
  received from the next stage (the last stage takes its own cotangent,
  ONE copy of it: every pipe rank computes the head and the loss on the
  same broadcast output, and the broadcast's backward must not sum their
  P copies), the stage's layers' gradients summed over the microbatches,
  and each microbatch's input gradient sent back to the stage before. The
  backward of a send is the reverse send.
So the stage-local leaves get their stage's gradients and stage 0 the
input's. What the caller computes around the pipeline runs on every pipe
rank alike: the leaves used after it (the final norm, the lm_head) get the
same gradient on every pipe rank, and the leaves that feed it (the
embedding, the projector, the tower) a gradient on stage 0 only
(tensor_parallel.py::Sharded.reduce_grads hands stage 0's to the others).

cos, sin and the padding mask travel with their microbatch; None entries
pass through as None. `adapter_route` does not compose with the pipeline
(the model raises, as JAX's does).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from teochat_torch.parallel import tensor_parallel as tp
from teochat_torch.utils import tree_leaves_with_path


def _tree_flatten(tree):
    """(leaves, rebuild) of a nested dict of tensors."""
    paths = [p for p, _ in tree_leaves_with_path(tree)]
    leaves = [x for _, x in tree_leaves_with_path(tree)]

    def rebuild(new):
        out = {}
        for path, x in zip(paths, new):
            node = out
            keys = path.split("/")
            for key in keys[:-1]:
                node = node.setdefault(key, {})
            node[keys[-1]] = x
        return out

    return leaves, rebuild


class _Plan:
    """What one call's schedule needs besides the differentiable inputs."""

    def __init__(self, block_fn, rebuild, args_mb, first, count, stage, p, group, m):
        self.block_fn, self.rebuild, self.args_mb = block_fn, rebuild, args_mb
        self.first, self.count, self.stage, self.p, self.group, self.m = (
            first, count, stage, p, group, m)

    def run_stage(self, x, leaves, j):
        """This stage's layers over microbatch j (each leaf unbound along
        its layer axis: one gradient stack, as models/llama.py::unstack_layers)."""
        per_layer = list(zip(*(t.unbind(0) for t in leaves)))
        for i in range(self.count):
            x = self.block_fn(x, self.rebuild(per_layer[i]), self.first + i, *self.args_mb[j])
        return x

    def forward(self, xs, leaves, keep: bool):
        """The schedule's forward; with `keep` each microbatch's (input,
        output) graph is returned for the backward."""
        outs, kept = [], []
        for j in range(self.m):
            if self.stage == 0:
                x_in = xs[j]
            else:
                (x_in,) = tp.exchange([], [(xs[j], self.stage - 1)], self.group)
            if keep:
                x_in = x_in.detach().requires_grad_(self.stage > 0 or xs.requires_grad)
            y = self.run_stage(x_in, leaves, j)
            if self.stage < self.p - 1:
                tp.exchange([(y.detach(), self.stage + 1)], [], self.group)
            outs.append(y.detach())
            kept.append((x_in, y))
        out = torch.stack(outs) if self.stage == self.p - 1 else torch.empty_like(xs)
        # the last stage's results to every pipe rank (JAX's psum of its buffer)
        return tp._broadcast(out, self.p - 1, self.group), kept


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan: _Plan, xs, *leaves):
        with torch.enable_grad():
            tracked = [x.detach().requires_grad_(x.requires_grad) for x in leaves]
            out, kept = plan.forward(xs, tracked, keep=True)
        ctx.plan, ctx.kept, ctx.tracked = plan, kept, tracked
        ctx.x_grad = xs.requires_grad
        return out

    @staticmethod
    def backward(ctx, g_out):
        plan, kept, tracked = ctx.plan, ctx.kept, ctx.tracked
        want = [i for i, x in enumerate(tracked) if x.requires_grad]
        grads = [None] * len(tracked)
        dxs = [None] * plan.m
        for j in reversed(range(plan.m)):
            x_in, y = kept[j]
            if plan.stage == plan.p - 1:
                g = g_out[j]  # one copy of the cotangent: the last stage's own
            else:
                (g,) = tp.exchange([], [(y, plan.stage + 1)], plan.group)
            inputs = ([x_in] if x_in.requires_grad else []) + [tracked[i] for i in want]
            got = torch.autograd.grad(y, inputs, g, allow_unused=True)
            if x_in.requires_grad:
                dx, got = got[0], got[1:]
                if dx is None:
                    dx = torch.zeros_like(x_in)
                if plan.stage > 0:
                    tp.exchange([(dx, plan.stage - 1)], [], plan.group)
                else:
                    dxs[j] = dx
            for i, gi in zip(want, got):
                if gi is not None:
                    grads[i] = gi if grads[i] is None else grads[i] + gi
            kept[j] = None  # the microbatch's graph is spent
        dx = torch.stack(dxs) if ctx.x_grad and plan.stage == 0 else None
        return (None, dx, *grads)


def pipelined_scan_blocks(
    layers,  # this stage's stacked [L/P, ...] leaves
    block_fn: Callable,  # (x, layer_params, layer_index, *mb_args) -> x
    x: torch.Tensor,  # [B, S, D]
    batched_args: Sequence[Optional[torch.Tensor]] = (),  # each [B, ...]
    *,
    sharded,
    num_layers: int,
    num_microbatches: Optional[int] = None,
) -> torch.Tensor:
    """All `num_layers` layers over x, the layer stack split over the `pipe`
    axis of `sharded` (parallel/tensor_parallel.py::Sharded). `layers` is
    this stage's slice of the stacked leaves (the mesh's local shards).
    Returns the full [B, S, D] result on every pipe rank.

    The batch splits into `num_microbatches` (default: the stage count)
    equal microbatches; B must divide evenly. `batched_args` (cos, sin,
    the padding mask: leading dim B) are split alike and travel with their
    microbatch; they take no gradient. `block_fn` gets the global index of
    each layer it runs."""
    sizes = {} if sharded is None else sharded.sizes
    if "pipe" not in sizes:
        raise ValueError(f"pipeline axis 'pipe' not in the active mesh {sizes}")
    p, stage = sizes["pipe"], sharded.coords["pipe"]
    if num_layers % p:
        raise ValueError(f"{num_layers} layers not divisible by pipe={p}")
    m = num_microbatches or p
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by {m} microbatches")
    count = num_layers // p
    leaves, rebuild = _tree_flatten(layers)
    if any(t.shape[0] != count for t in leaves):
        raise ValueError(f"pipelined_scan_blocks: layer leaves of leading dims "
                         f"{sorted({t.shape[0] for t in leaves})}, not this stage's {count}")
    if any(a is not None and a.requires_grad for a in batched_args):
        raise ValueError("pipelined_scan_blocks: batched_args take no gradient")
    split = [None if a is None else a.reshape(m, b // m, *a.shape[1:]) for a in batched_args]
    args_mb = [tuple(None if a is None else a[j] for a in split) for j in range(m)]
    plan = _Plan(block_fn, rebuild, args_mb, stage * count, count, stage, p,
                 sharded.groups["pipe"], m)
    xs = x.reshape(m, b // m, *x.shape[1:])
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in leaves)):
        out = _Pipeline.apply(plan, xs, *leaves)
    else:
        with torch.no_grad():
            out, _ = plan.forward(xs, leaves, keep=False)
    return out.reshape(x.shape)
