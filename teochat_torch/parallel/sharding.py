"""Placement rules: Megatron-style tensor parallelism and ZeRO-3 on the mesh
(port of teochat_tpu/parallel/sharding.py).

`_RULES` is the JAX module's table, a copy: each leaf path of the
{'vision', 'projector', 'llm'} tree maps to a spec, one entry a tensor dim
(None, or the mesh axis that splits it), first match wins:

- column-parallel projections (q / k / v, gate / up, fc1, MPT's wqkv and
  up_proj) split their OUTPUT dim on `model` and their input dim on `fsdp`;
- row-parallel ones (out, down, fc2, out_proj, down_proj) their INPUT dim on
  `model` and their output dim on `fsdp`;
- embeddings and the lm_head split the vocabulary on `model`;
- norms and most biases replicate.

`param_specs` is the JAX function (the multi-LoRA adapter axis replicated,
ranks clipped, a decoder layer leaf's unsharded leading dim on `pipe` where
the mesh has that axis, `_fit_spec` dropping an axis a dim cannot divide).
No leaf takes `sequence`: the ring splits activations, not weights.
`placement_specs` adds what the port's compute needs, since it runs each
rank's own heads where GSPMD would reshard: a block whose heads (or MLP
columns, or vocabulary) the `model` axis does not divide replicates over
`model` whole (TinyLlama's 4 kv heads over `model` 8 replicate its
attention).

`shard_params` places each leaf as a DTensor, slicing the full tensor every
rank holds (built from one seed) with no communication. A fused leaf (the
int8 q|k|v and gate|up, MPT's wqkv, their scales, biases and LoRA B) is
laid out per rank first: rank r's columns are its own segment chunks, [its
q heads | its k heads | its v heads], where JAX's contiguous split would cut
across the segments. `fused_segments` names them; `unshard` and the
checkpoint writer (checkpoint/orbax_io.py) put the columns back in order.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from teochat_torch.utils import tree_map_with_path

Spec = Tuple  # one entry a tensor dim: None, an axis name, or a tuple of names


def P(*axes) -> Spec:
    return tuple(axes)


_RULES: Tuple[Tuple[str, Spec], ...] = (
    # --- LLaMA decoder (stacked [L, ...]) ---
    (r"llm/layers/attn/(q|k|v)/kernel$", P(None, "fsdp", "model")),
    (r"llm/layers/attn/out/kernel$", P(None, "model", "fsdp")),
    (r"llm/layers/mlp/(gate|up)/kernel$", P(None, "fsdp", "model")),
    (r"llm/layers/mlp/down/kernel$", P(None, "model", "fsdp")),
    (r"llm/layers/.*norm.*$", P()),
    (r"llm/embed_tokens/embedding$", P("model", "fsdp")),
    (r"llm/lm_head/kernel$", P("fsdp", "model")),
    (r"llm/final_norm/.*$", P()),
    # --- int8 quant scales follow their kernel's output dim ---
    (r"llm/layers/attn/(q|k|v)/scale$", P(None, "model")),
    (r"llm/layers/attn/out/scale$", P(None, "fsdp")),
    (r"llm/layers/mlp/(gate|up)/scale$", P(None, "model")),
    (r"llm/layers/mlp/down/scale$", P(None, "fsdp")),
    (r"llm/lm_head/scale$", P("model")),
    # --- int4 packed weights: flat 'packed' mirrors its kernel;
    # 'packed_tiles' [L, out/bn, in/2, bn] shards the tile axis like the
    # kernel's output dim ---
    (r"llm/layers/attn/(q|k|v)/packed$", P(None, "fsdp", "model")),
    (r"llm/layers/attn/out/packed$", P(None, "model", "fsdp")),
    (r"llm/layers/mlp/(gate|up)/packed$", P(None, "fsdp", "model")),
    (r"llm/layers/mlp/down/packed$", P(None, "model", "fsdp")),
    (r"llm/lm_head/packed$", P("fsdp", "model")),
    (r"llm/layers/attn/(q|k|v)/packed_tiles$", P(None, "model", "fsdp", None)),
    (r"llm/layers/attn/out/packed_tiles$", P(None, "fsdp", "model", None)),
    (r"llm/layers/mlp/(gate|up)/packed_tiles$", P(None, "model", "fsdp", None)),
    (r"llm/layers/mlp/down/packed_tiles$", P(None, "fsdp", "model", None)),
    (r"llm/lm_head/packed_tiles$", P("model", "fsdp", None)),
    # --- fused q|k|v and gate|up: column-parallel like their parts ---
    (r"llm/layers/(attn/qkv|mlp/gateup)/kernel$", P(None, "fsdp", "model")),
    (r"llm/layers/(attn/qkv|mlp/gateup)/scale$", P(None, "model")),
    (r"llm/layers/(attn/qkv|mlp/gateup)/packed$", P(None, "fsdp", "model")),
    (r"llm/layers/(attn/qkv|mlp/gateup)/packed_tiles$", P(None, "model", "fsdp", None)),
    # --- MPT decoder: wqkv / up column-parallel, out / down row-parallel;
    # biases and int8 scales follow their kernel's output dim ---
    (r"llm/layers/wqkv/kernel$", P(None, "fsdp", "model")),
    (r"llm/layers/out_proj/kernel$", P(None, "model", "fsdp")),
    (r"llm/layers/up_proj/kernel$", P(None, "fsdp", "model")),
    (r"llm/layers/down_proj/kernel$", P(None, "model", "fsdp")),
    (r"llm/layers/(wqkv|up_proj)/(bias|scale)$", P(None, "model")),
    (r"llm/layers/(out_proj|down_proj)/(bias|scale)$", P(None, "fsdp")),
    (r"llm/layers/(norm1|norm2)/.*$", P()),
    (r"llm/wte/embedding$", P("model", "fsdp")),
    # --- Vision tower (stacked [L, ...]) ---
    (r"vision/layers/(temporal_attn|attn)/(q|k|v)/kernel$", P(None, "fsdp", "model")),
    (r"vision/layers/(temporal_attn|attn)/(q|k|v)/bias$", P(None, "model")),
    (r"vision/layers/(temporal_attn|attn)/out/kernel$", P(None, "model", "fsdp")),
    (r"vision/layers/mlp/fc1/kernel$", P(None, "fsdp", "model")),
    (r"vision/layers/mlp/fc1/bias$", P(None, "model")),
    (r"vision/layers/mlp/fc2/kernel$", P(None, "model", "fsdp")),
    (r"vision/(patch_embedding/kernel|position_embedding)$", P(None, "fsdp")),
    # --- Projector ---
    (r"projector/layers/\d+/kernel$", P("fsdp", "model")),
    # --- LoRA adapters: A column-ish, B row-ish ---
    (r".*/lora_a$", P(None, "fsdp", None)),
    (r".*/lora_b$", P(None, None, "model")),
)

_DEFAULT = P()


def spec_for_path(path_s: str) -> Spec:
    for pattern, spec in _RULES:
        if re.search(pattern, path_s):
            return spec
    return _DEFAULT


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh, or of a mapping of that form (a JAX
    mesh's `.shape`, which the tests pass)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _fit_spec(spec: Spec, shape, sizes: Mapping[str, int]) -> Spec:
    """Drop the mesh axes a leaf dim cannot divide (replicate that dim)."""
    axes = []
    for i, ax in enumerate(spec):
        if ax is None:
            axes.append(None)
            continue
        names = ax if isinstance(ax, tuple) else (ax,)
        size = 1
        for n in names:
            size *= sizes[n]
        axes.append(ax if shape[i] % size == 0 else None)
    return P(*axes)


def _leaf_spec(path_s: str, leaf, sizes: Optional[Mapping[str, int]]) -> Spec:
    """JAX's spec of one leaf, fitted to the mesh's `sizes` where given."""
    spec = spec_for_path(path_s)
    if path_s.endswith(("lora_a", "lora_b")) and leaf.ndim == len(spec) + 1:
        # adapter-stacked multi-LoRA leaf [L, A, in, r]: the adapter axis
        # replicates, in / rank keep the single-adapter placement
        spec = P(spec[0], None, *spec[1:])
    if len(spec) > leaf.ndim:
        spec = P(*spec[: leaf.ndim])
    if (sizes is not None and "pipe" in sizes and path_s.startswith("llm/layers/")
            and leaf.ndim >= 1 and (len(spec) == 0 or spec[0] is None)):
        # pipeline parallelism (parallel/pipeline.py): the stacked layer
        # axis splits over `pipe`, each stage holding its layers
        spec = P("pipe", *spec[1:])
    if sizes is not None:
        spec = _fit_spec(spec, leaf.shape, sizes)
    return spec


def param_specs(params: Dict, mesh=None) -> Dict:
    """A tree of specs mirroring `params` (JAX's param_specs; with `mesh`
    each spec fitted to its leaf)."""
    sizes = None if mesh is None else axis_sizes(mesh)
    return tree_map_with_path(lambda p, x: _leaf_spec(p, x, sizes), params)


# ------------------------------------------------------------ the port's placements

# the leaves of a block the `model` axis splits by heads or columns
_ATTN = r"^llm/layers/(attn/|wqkv/|out_proj/)"
_MLP = r"^llm/layers/(mlp/|up_proj/|down_proj/)"
_VOCAB = r"^llm/(embed_tokens|lm_head|wte)/"
_VIT_ATTN = r"^vision/layers/(attn|temporal_attn)/"
_VIT_MLP = r"^vision/layers/mlp/"


def _llm_dims(llm_cfg):
    """(query heads, kv heads, MLP width, vocabulary) of a LLaMA or MPT config."""
    if hasattr(llm_cfg, "d_model"):  # MPT
        return (llm_cfg.n_heads, llm_cfg.num_kv_heads, llm_cfg.expansion_ratio * llm_cfg.d_model,
                llm_cfg.vocab_size)
    return (llm_cfg.num_heads, llm_cfg.num_kv_heads, llm_cfg.intermediate_size,
            llm_cfg.vocab_size)


def model_split(cfg, m: int) -> Dict[str, bool]:
    """Which blocks `model` of size m splits: each one whose heads (or
    columns, or vocabulary) it divides."""
    h, hkv, inter, vocab = _llm_dims(cfg.llm)
    return {
        _ATTN: h % m == 0 and hkv % m == 0,
        _MLP: inter % m == 0,
        _VOCAB: vocab % m == 0,
        _VIT_ATTN: cfg.vision.num_heads % m == 0,
        _VIT_MLP: cfg.vision.intermediate_size % m == 0,
    }


def fused_segments(path_s: str, cfg) -> Optional[Tuple[int, ...]]:
    """The column segments of a fused leaf along its last dim ([q | k | v]
    or [gate | up]), or None for any other leaf."""
    h, hkv, inter, _ = _llm_dims(cfg.llm)
    hd = cfg.llm.head_dim
    if re.search(r"^llm/layers/(attn/qkv|wqkv)/(kernel|scale|bias|lora_b)$", path_s):
        return (h * hd, hkv * hd, hkv * hd)
    if re.search(r"^llm/layers/mlp/gateup/(kernel|scale|bias|lora_b)$", path_s):
        return (inter, inter)
    return None


def _placement_spec(path_s: str, leaf, sizes: Mapping[str, int], split) -> Spec:
    spec = _leaf_spec(path_s, leaf, sizes)
    for pattern, ok in split.items():
        if not ok and re.search(pattern, path_s):
            return P(*(None if ax == "model" else ax for ax in spec))
    return spec


def placement_specs(params: Dict, mesh, cfg) -> Dict:
    """param_specs fitted to `mesh`, with `model` dropped from every leaf of
    a block it does not split (model_split)."""
    sizes = axis_sizes(mesh)
    split = model_split(cfg, sizes["model"])
    return tree_map_with_path(lambda p, x: _placement_spec(p, x, sizes, split), params)


def placements(spec: Spec, mesh_names: Sequence[str]):
    """DTensor placements of a spec: Shard(dim) on each axis that splits a
    dim, Replicate on the others."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh_names:
        dims = [d for d, ax in enumerate(spec) if ax == name]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def spec_of(dtensor) -> Spec:
    """The spec a DTensor's placements spell (the inverse of `placements`)."""
    spec = [None] * dtensor.ndim
    for name, pl in zip(dtensor.device_mesh.mesh_dim_names, dtensor.placements):
        if pl.is_shard():
            spec[pl.dim] = name
    return P(*spec)


def local_chunk(x: torch.Tensor, spec: Spec, sizes: Mapping[str, int],
                coords: Mapping[str, int], segments: Optional[Sequence[int]] = None
                ) -> torch.Tensor:
    """This rank's block of the full tensor `x` under `spec`; a fused leaf's
    `model` columns are the rank's chunk of each segment, concatenated."""
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        n, i = sizes[ax], coords[ax]
        if segments is not None and ax == "model" and d == x.ndim - 1:
            x = torch.cat([seg.chunk(n, d)[i] for seg in x.split(list(segments), d)], d)
        else:
            x = x.chunk(n, d)[i]
    return x


def shard_params(params: Dict, mesh, cfg) -> Dict:
    """Each leaf of the full tree (the same on every rank) as a DTensor on
    `mesh`, placed by `placement_specs`; no communication."""
    from torch.distributed.tensor import DTensor

    sizes = axis_sizes(mesh)
    names = mesh.mesh_dim_names
    coords = {n: mesh.get_local_rank(n) for n in names}
    split = model_split(cfg, sizes["model"])

    def place(path_s, x):
        spec = _placement_spec(path_s, x, sizes, split)
        local = local_chunk(x, spec, sizes, coords, fused_segments(path_s, cfg))
        if any(ax is not None and sizes[ax] > 1 for ax in spec):
            local = local.clone(memory_format=torch.contiguous_format)  # not a view of x
        return DTensor.from_local(local, mesh, placements(spec, names), run_check=False,
                                  shape=x.shape, stride=torch.empty(x.shape, device="meta").stride())

    return tree_map_with_path(place, params)


def canonical_columns(x: torch.Tensor, segments: Sequence[int], m: int) -> torch.Tensor:
    """A fused leaf's columns back in order from the per-rank layout (the
    `model` ranks' chunks concatenated, each [its chunk of every segment])."""
    per_rank = [chunk.split([s // m for s in segments], -1) for chunk in x.chunk(m, -1)]
    return torch.cat([torch.cat([r[j] for r in per_rank], -1) for j in range(len(segments))], -1)


def unshard(x, path_s: str, cfg) -> torch.Tensor:
    """The full tensor of a DTensor leaf, a fused leaf's columns in their
    canonical order (every rank takes part: an all-gather)."""
    from teochat_torch.parallel.tensor_parallel import gather_dtensor

    full = gather_dtensor(x)
    segments = fused_segments(path_s, cfg)
    spec = spec_of(x)
    if segments is None or not spec or spec[-1] != "model":
        return full
    return canonical_columns(full, segments, axis_sizes(x.device_mesh)["model"])


def batch_spec(train: bool = False) -> Spec:
    """Leading-batch activation spec: training rows over (data, fsdp)."""
    return P(("data", "fsdp")) if train else P("data")

