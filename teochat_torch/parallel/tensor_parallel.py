"""The collectives a forward on the mesh runs, and the run's view of the mesh.

GSPMD inserts the communication from the specs; here it is written out
(Megatron's f / g operators, ZeRO-3's gathers), as autograd functions whose
backward is the collective's conjugate:

- `gather_fsdp`: all-gather a leaf's fsdp shards at use, one layer at a
  time; its backward reduce-scatters (sums) the gradient over `fsdp`;
- `to_model`: identity forward, all-reduce backward: an activation (or a
  weight) that every `model` rank holds whole, entering rank-dependent
  work (Megatron's f);
- `reduce_model`: all-reduce forward (the fp32 partial sums of a
  row-parallel product), identity backward (Megatron's g);
- `gather_model`: all-gather forward along a dim, backward the rank's own
  slice: a model-sharded tensor that what follows uses whole and the same
  on every `model` rank (the vocab-parallel logits, a row-parallel LoRA B,
  the projector's kernels).

`Sharded` holds the mesh, this rank's coordinates and each leaf's spec (read
from the DTensor placements `parallel.sharding.shard_params` gave it), and
the operations the models call on the mesh. A mesh axis of size 1 makes its
collectives no-ops on every rank alike.

Gradients: a leaf sharded on `fsdp` gets its fsdp sum from the gather's
backward; `reduce_grads` all-reduces the others over `fsdp`, and every leaf
over `data` (rows only) and `sequence` (each rank's chunk of the tokens). A
leaf replicated over `model` is either used the same way on every model
rank (a norm: equal gradients, nothing to sum) or enters through `to_model`
(a LoRA A on a split block), whose backward sums it. On a `pipe` axis the
stages hold their own layers; every other leaf takes stage 0's gradient
(parallel/pipeline.py says why). The loss is each rank's sum over its
tokens divided by the global count of valid labels (`sum_rows`), so the
summed gradients are the global mean's.

`exchange` is the point-to-point traffic of the ring
(parallel/ring_attention.py) and the pipeline (parallel/pipeline.py).
"""

from __future__ import annotations

import re
from typing import Dict

import torch
import torch.distributed as dist

from teochat_torch.ops.quant import matmul_fp32, quantized_proj
from teochat_torch.parallel import sharding as sharding_mod
from teochat_torch.utils import tree_leaves_with_path, tree_map, tree_map_with_path


def _all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ranks' x concatenated along `dim`, in rank order."""
    buf = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(buf, x.contiguous().reshape(-1), group=group)
    return torch.cat(buf.view(n, *x.shape).unbind(0), dim)


def _reduce_scatter(g: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The sum over the ranks of g, this rank's chunk of it along `dim`."""
    moved = g.movedim(dim, 0).contiguous()
    out = torch.empty(moved.numel() // n, dtype=g.dtype, device=g.device)
    dist.reduce_scatter_tensor(out, moved.reshape(-1), group=group)
    return out.view(moved.shape[0] // n, *moved.shape[1:]).movedim(0, dim)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """x from the group's rank `src` to every rank of the group, in place."""
    dist.broadcast(x, dist.get_global_rank(group, src), group=group)
    return x


# point-to-point traffic copied through pinned host buffers (exchange's
# gloo path on CUDA tensors): calls and bytes sent, for a run to report
HOST_STAGED = {"calls": 0, "bytes": 0}


def exchange(sends, recvs, group):
    """Point-to-point on `group`: each (tensor, group rank) of `sends` is sent
    to that rank, and each (like, group rank) of `recvs` received from it
    into a new tensor shaped, typed and placed as `like`; returns those.
    Every rank names its sends and receives in the same order as its peers.

    The transport is the group's backend's: NCCL (one process a card) takes
    CUDA tensors in `batch_isend_irecv`; gloo takes host tensors only, so on
    CUDA tensors (two ranks sharing one card) each is copied through a
    pinned host buffer and counted on HOST_STAGED, never silently."""
    if not sends and not recvs:
        return []
    dev = (sends[0][0] if sends else recvs[0][0]).device
    staged = dist.get_backend(group) == "gloo" and dev.type == "cuda"

    def host(x):
        if not staged:
            return x.contiguous()
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)
        return buf

    out_bufs = [torch.empty(like.shape, dtype=like.dtype, device="cpu" if staged else dev,
                            pin_memory=staged) for like, _ in recvs]
    ops = [dist.P2POp(dist.isend, host(x), dist.get_global_rank(group, r), group)
           for x, r in sends]
    ops += [dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, r), group)
            for buf, (_, r) in zip(out_bufs, recvs)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if not staged:
        return out_bufs
    HOST_STAGED["calls"] += 1
    HOST_STAGED["bytes"] += sum(x.numel() * x.element_size() for x, _ in sends)
    return [buf.to(dev, non_blocking=True) for buf in out_bufs]


class _GatherFsdp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, group, n: int):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return _all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group, ctx.n), None, None, None


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, group, n: int, rank: int):
        ctx.dim, ctx.n, ctx.rank = dim, n, rank
        return _all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, ctx.dim)[ctx.rank].contiguous(), None, None, None, None


def gather_dtensor(x) -> torch.Tensor:
    """A DTensor's whole tensor (its placements' layout), by an all-gather
    over each mesh axis that shards it: c10d collectives, which gloo takes
    on CUDA tensors, where DTensor's own `full_tensor` goes through
    functional collectives (two ranks on one card crash there)."""
    out = x.to_local()
    mesh = x.device_mesh
    for i, (name, pl) in enumerate(zip(mesh.mesh_dim_names, x.placements)):
        if pl.is_shard() and mesh.size(i) > 1:
            out = _all_gather(out, pl.dim, mesh.get_group(name), mesh.size(i))
    return out


def local_tensor(x) -> torch.Tensor:
    """A DTensor's local shard (a view of its storage: in-place updates reach
    the DTensor), or the tensor itself."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        with torch.no_grad():
            return x.to_local()
    return x


# the blocks `model` splits, by name (parallel.sharding.model_split's keys)
BLOCKS = {"attn": sharding_mod._ATTN, "mlp": sharding_mod._MLP, "vocab": sharding_mod._VOCAB,
          "vit_attn": sharding_mod._VIT_ATTN, "vit_mlp": sharding_mod._VIT_MLP}


class Sharded:
    """A training forward's view of the mesh: `params` is the tree of
    DTensors `shard_params` made, `cfg` the model's config."""

    def __init__(self, mesh, cfg, params: Dict):
        from torch.distributed.tensor import DTensor

        self.mesh, self.cfg = mesh, cfg
        self.names = tuple(mesh.mesh_dim_names)
        self.sizes = sharding_mod.axis_sizes(mesh)
        self.coords = {n: mesh.get_local_rank(n) for n in self.names}
        self.groups = {n: mesh.get_group(n) for n in self.names}
        self.specs = {p: sharding_mod.spec_of(x) if isinstance(x, DTensor) else ()
                      for p, x in tree_leaves_with_path(params)}
        split = sharding_mod.model_split(cfg, self.sizes["model"])
        self._split = {name: split[pattern] for name, pattern in BLOCKS.items()}
        self.m, self.model_rank = self.sizes["model"], self.coords["model"]

    # ------------------------------------------------------------ placement

    def splits(self, block: str) -> bool:
        """Whether `model` splits a block ('attn', 'mlp', 'vocab', 'vit_attn',
        'vit_mlp') over more than one rank."""
        return self.m > 1 and self._split[block]

    def local(self, tree):
        return tree_map(local_tensor, tree)

    def gather(self, tree, prefix: str, lead: int = 0):
        """`tree` (the local leaves under `prefix`) with each leaf's fsdp dim
        gathered; `lead` leading dims of the stored leaves are gone (1 for
        one layer of a stacked [L, ...] tree)."""
        n = self.sizes["fsdp"]

        def one(sub, x):
            spec = self.specs[f"{prefix}/{sub}" if sub else prefix][lead:]
            if n == 1 or "fsdp" not in spec:
                return x
            return _GatherFsdp.apply(x, spec.index("fsdp"), self.groups["fsdp"], n)

        return tree_map_with_path(one, tree)

    # ------------------------------------------------------------ model axis

    def to_model(self, x: torch.Tensor) -> torch.Tensor:
        return _ToModel.apply(x, self.groups["model"]) if self.m > 1 else x

    def reduce_model(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceModel.apply(x, self.groups["model"]) if self.m > 1 else x

    def reduce_model_sum(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce over `model`, outside autograd (inside a Function's forward)."""
        return _all_reduce(x, self.groups["model"]) if self.m > 1 else x

    def gather_model(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        if self.m == 1:
            return x
        return _GatherModel.apply(x, dim % x.ndim, self.groups["model"], self.m,
                                  self.model_rank)

    def col(self, p: Dict) -> Dict:
        """A column-parallel projection's leaves: its LoRA A, whole on every
        model rank but feeding the rank's own columns, enters by to_model."""
        if "lora_a" not in p:
            return p
        return {**p, "lora_a": self.to_model(p["lora_a"])}

    def row_proj(self, x: torch.Tensor, p: Dict) -> torch.Tensor:
        """A row-parallel projection: x [..., in/m] is this model rank's
        input columns, the kernel its rows. The fp32 partial sums are
        all-reduced over `model` before the one rounding to x's dtype (an
        int8 kernel's scale applied after the sum, F2); a LoRA adapter's
        x A likewise (A's rows of this rank, F2b), then times B whole; a
        bias is added once, after the sum."""
        if "scale" in p:
            y = quantized_proj(x, p, reduce=self.reduce_model_sum)
        else:
            y = self.reduce_model(matmul_fp32(x, p["kernel"].to(x.dtype))).to(x.dtype)
        if "lora_a" in p:
            a = self.own_rows(p["lora_a"]).to(x.dtype)
            xa = self.reduce_model(matmul_fp32(x, a)).to(x.dtype)
            b = self.gather_model(p["lora_b"], -1).to(x.dtype)
            y = y + (matmul_fp32(xa, b) * p["lora_scale"].detach().float()).to(x.dtype)
        if "bias" in p:
            y = y + p["bias"].to(x.dtype)
        return y

    def own_rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This model rank's chunk of a tensor every model rank holds whole
        (entering by to_model: its gradient sums the ranks')."""
        return self.to_model(x).chunk(self.m, dim)[self.model_rank]

    def vocab_embed(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows of a vocab-sharded table [V/m, D]: each rank looks up the ids
        in its range, zero elsewhere, summed over `model`."""
        if not self.splits("vocab"):
            return table[ids]
        v = table.shape[0]
        local = ids - self.model_rank * v
        inside = (local >= 0) & (local < v)
        rows = table[local.clamp(0, v - 1)]
        return self.reduce_model(torch.where(inside[..., None], rows, torch.zeros_like(rows)))

    # ------------------------------------------------------------ batch rows

    def sum_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks that hold other tokens (data, fsdp: other rows;
        sequence: other chunks of them), outside autograd."""
        x = x.detach()
        for name in ("data", "fsdp", "sequence"):
            if self.sizes.get(name, 1) > 1:
                x = _all_reduce(x, self.groups[name])
        return x

    # ------------------------------------------------------------ sequence, pipe

    @property
    def seq(self) -> int:
        return self.sizes.get("sequence", 1)

    @property
    def pipe(self) -> int:
        return self.sizes.get("pipe", 1)

    def own_sequence(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's contiguous chunk of x along `dim` over `sequence`
        (its global positions [i S/n, (i+1) S/n)); S must divide by n, as
        JAX's ring requires."""
        n = self.seq
        if n == 1:
            return x
        if x.shape[dim] % n:
            raise ValueError(f"sequence length {x.shape[dim]} not divisible by sequence={n}")
        return x.chunk(n, dim)[self.coords["sequence"]]

    @property
    def row_rank(self) -> int:
        """This rank's index among the (data, fsdp) row groups: batch_spec(train=True)."""
        return self.coords["data"] * self.sizes["fsdp"] + self.coords["fsdp"]

    @property
    def row_count(self) -> int:
        return self.sizes["data"] * self.sizes["fsdp"]

    # ------------------------------------------------------------ gradients

    def reduce_grads(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Sum each trainable leaf's gradient over the ranks that hold other
        tokens: over `fsdp` where the gather's backward has not, over `data`
        and over `sequence` (each rank's chunk contributes to every leaf).
        On a `pipe` axis a leaf that the stages do not split (the embedding,
        projector and tower that feed stage 0; the final norm and lm_head
        after the pipeline, whose gradient every pipe rank computes alike)
        takes stage 0's gradient, which is whole: summing would count the
        head's P times."""
        out = {}
        for path, g in grads.items():
            if self.sizes["fsdp"] > 1 and "fsdp" not in self.specs[path]:
                g = _all_reduce(g, self.groups["fsdp"])
            for name in ("data", "sequence"):
                if self.sizes.get(name, 1) > 1:
                    g = _all_reduce(g, self.groups[name])
            if self.pipe > 1 and "pipe" not in self.specs[path]:
                g = _broadcast(g.contiguous(), 0, self.groups["pipe"])
            out[path] = g
        return out

    def global_sq_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The squared global norm of the gradient tree: each shard's sum of
        squares, a leaf's replicas counted once (the rank at coordinate 0 of
        each axis that does not split it), summed over every rank."""
        dev = next(iter(grads.values())).device
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for path, g in grads.items():
            spec = self.specs[path]
            if all(self.coords[n] == 0 for n in self.names if n not in spec):
                total = total + g.float().pow(2).sum()
        dist.all_reduce(total)
        return total


def check_trainable_on_mesh(params) -> None:
    """Leaves the mesh path does not take: int4 (a serving format), the
    adapter-stacked multi-LoRA leaves (serving), an lm_head adapter, a w8a8
    tower. Raises a ValueError naming the first."""
    for path, x in tree_leaves_with_path(params):
        if re.search(r"/(packed|packed_tiles)$", path):
            raise ValueError(f"{path}: int4 leaves are a serving format; the mesh path trains")
        if re.search(r"/lora_[ab]$", path) and x.ndim == 4:
            raise ValueError(f"{path}: adapter-stacked (multi-LoRA) leaves are for serving")
        if path.startswith("llm/lm_head/lora"):
            raise ValueError(f"{path}: an lm_head adapter does not run on a mesh")
        if re.search(r"^vision/layers/(attn|temporal_attn|mlp)/\w+/scale$", path):
            raise ValueError(f"{path}: a w8a8 tower does not run on a mesh")
