"""Checkpoint save / load / auto-resume (port of teochat_tpu/checkpoint/orbax_io.py).

The JAX module keeps the name of the library it writes with (Orbax); the
port keeps the module name, the signatures and the directory layout,
`path[/checkpoint-N]/{params, opt_state, config.json}`, and writes a format
of its own, since the card has neither Orbax nor JAX: each of `params/` and
`opt_state/` holds one safetensors file of the flattened tree, a tensor a
leaf keyed by its `/`-joined path, and the tree's structure (dicts, lists,
the Python numbers of the optimizer state) as JSON in the file's metadata.
Each leaf is written from its own bytes, so leaves that share storage (the
frozen leaves of a LoRA tree) or are views are written whole, once each.
`latest_checkpoint` is the reference's checkpoint-* auto-resume glob
(train.py:1109-1112).

On a mesh (params as DTensors, parallel/sharding.py) each of `params/` and
`opt_state/` is a `torch.distributed.checkpoint` directory instead: every
rank writes its own shards, once each (a replicated leaf once in all), and
rank 0 the tree's structure (`tree.json`) and `config.json`. An optimizer
moment, a plain tensor the shape of its leaf's local shard, is written as
a DTensor with its leaf's placements. A fused leaf split over `model`
(its columns laid out per rank) is written as one tensor a segment (`#0`,
`#1`, ...), so the files hold the canonical columns. The files name no
topology: a sharded checkpoint loads on one process (whole tensors) or on
any mesh (the templates' placements), and a one-process checkpoint loads
on a mesh, as JAX's never persist the run's topology (train.py:376-380).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import struct
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from teochat_torch.config import TEOChatConfig
from teochat_torch.parallel import sharding as sharding_mod
from teochat_torch.utils import tree_leaves_with_path, tree_map_with_path

TREE_FILE = "tree.safetensors"
SHARDED_TREE = "tree.json"  # a sharded checkpoint's structure, beside its shards
_ST_DTYPES = {
    torch.float64: "F64", torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
    torch.int64: "I64", torch.int32: "I32", torch.int16: "I16", torch.int8: "I8",
    torch.uint8: "U8", torch.bool: "BOOL", torch.float8_e4m3fn: "F8_E4M3",
    torch.float8_e5m2: "F8_E5M2",
}


def _skeleton(tree, prefix: str, tensors: Dict[str, torch.Tensor]):
    """The tree's structure as JSON, its tensors gathered into `tensors` by path."""
    if isinstance(tree, dict):
        return {"d": {str(k): _skeleton(v, f"{prefix}/{k}" if prefix else str(k), tensors)
                      for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"l": [_skeleton(v, f"{prefix}/{i}" if prefix else str(i), tensors)
                      for i, v in enumerate(tree)]}
    if isinstance(tree, torch.Tensor):
        if prefix in tensors:
            raise ValueError(f"two leaves of the tree have the path {prefix!r}")
        tensors[prefix] = tree
        return {"t": prefix}
    if tree is None or isinstance(tree, (bool, int, float)):
        return {"v": tree}
    raise TypeError(f"cannot save a leaf of type {type(tree).__name__} at {prefix!r}")


def _rebuild(skel, leaf):
    if "d" in skel:
        return {k: _rebuild(v, leaf) for k, v in skel["d"].items()}
    if "l" in skel:
        return [_rebuild(v, leaf) for v in skel["l"]]
    if "t" in skel:
        return leaf(skel["t"])
    return skel["v"]


def _host_bytes(t: torch.Tensor):
    """The tensor's bytes as a host buffer (a contiguous copy of its elements)."""
    return t.detach().reshape(-1).contiguous().cpu().view(torch.uint8).numpy()


def _write_tree(file: str, tree) -> None:
    """Write `tree` as one safetensors file: a tensor a leaf, keyed by path,
    streamed to the file one leaf at a time."""
    tensors: Dict[str, torch.Tensor] = {}
    skel = _skeleton(tree, "", tensors)
    header: Dict[str, Any] = {"__metadata__": {"tree": json.dumps(skel)}}
    offset = 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
    with open(file, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(_host_bytes(t))


def _read_tree(file: str, template: Any = None):
    """Read a tree written by `_write_tree`. With a template (a live tree of
    the same structure) each tensor comes back in the template leaf's dtype
    on its device, and the structure must match it."""
    from safetensors import safe_open

    with safe_open(file, framework="pt", device="cpu") as f:
        skel = json.loads(f.metadata()["tree"])
        if template is None:
            return _rebuild(skel, f.get_tensor)
        want = {p: x for p, x in tree_leaves_with_path(template) if isinstance(x, torch.Tensor)}
        saved = set(f.keys())
        if saved != set(want):
            raise ValueError(f"{file} does not hold the template's tensors: "
                             f"{sorted(saved ^ set(want))[:8]}")

        def leaf(key):
            t = want[key]
            return f.get_tensor(key).to(device=t.device, dtype=t.dtype)

        return _rebuild(skel, leaf)


# ------------------------------------------------------------------ sharded


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _on_mesh(tree) -> bool:
    return any(_is_dtensor(x) for _, x in tree_leaves_with_path(tree))


def _param_of(name: str, like: Dict[str, Any]) -> Optional[str]:
    """The param path a tree's tensor belongs to: itself, or the key of an
    optimizer state's moment ('mu/<path>', 'inner/nu/<path>', 'acc/<path>')."""
    parts = name.split("/")
    for i in range(len(parts)):
        cand = "/".join(parts[i:])
        if cand in like:
            return cand
    return None


def _segments(param: Optional[str], ref, cfg) -> Optional[Tuple[int, ...]]:
    """A fused leaf's segments where its columns are split over `model`."""
    if param is None or ref is None:
        return None
    spec = sharding_mod.spec_of(ref)
    segs = sharding_mod.fused_segments(param, cfg) if cfg is not None else None
    if spec and spec[-1] == "model" and sharding_mod.axis_sizes(ref.device_mesh)["model"] > 1:
        if segs is None and re.search(r"/(qkv|gateup|wqkv)/", param):
            raise ValueError(f"{param}: a fused leaf split over `model` needs the config")
        return segs
    return None


def _as_dtensor(local: torch.Tensor, ref, shape=None):
    from torch.distributed.tensor import DTensor

    shape = tuple(ref.shape if shape is None else shape)
    return DTensor.from_local(local, ref.device_mesh, ref.placements, run_check=False,
                              shape=shape, stride=torch.empty(shape, device="meta").stride())


def _saved_pieces(name: str, t, like, cfg) -> Dict[str, Any]:
    """The DTensors one leaf is written as: itself; a moment with its
    param's placements; a split fused leaf one a segment."""
    param = _param_of(name, like)
    ref = like.get(param)
    if ref is None:
        return {name: t}
    local = t.to_local() if _is_dtensor(t) else t
    segs = _segments(param, ref, cfg)
    if segs is None:
        return {name: t if _is_dtensor(t) else _as_dtensor(local, ref)}
    m = sharding_mod.axis_sizes(ref.device_mesh)["model"]
    pieces = local.split([s // m for s in segs], -1)
    return {f"{name}#{j}": _as_dtensor(piece.contiguous(), ref, (*ref.shape[:-1], s))
            for j, (piece, s) in enumerate(zip(pieces, segs))}


def _save_sharded(path: str, params: Dict, cfg, opt_state) -> str:
    import torch.distributed.checkpoint as dcp

    rank0 = dist.get_rank() == 0
    if rank0:
        os.makedirs(path, exist_ok=True)
        for sub in ("params", "opt_state"):
            shutil.rmtree(os.path.join(path, sub), ignore_errors=True)
    dist.barrier()
    like = {p: x for p, x in tree_leaves_with_path(params) if _is_dtensor(x)}
    for sub, tree in (("params", params), ("opt_state", opt_state)):
        if tree is None:
            continue
        tensors: Dict[str, torch.Tensor] = {}
        skel = _skeleton(tree, "", tensors)
        state = {}
        for name, t in tensors.items():
            state.update(_saved_pieces(name, t, like, cfg))
        dcp.save(state, checkpoint_id=os.path.join(path, sub))
        if rank0:
            with open(os.path.join(path, sub, SHARDED_TREE), "w") as f:
                json.dump(skel, f)
    if rank0 and cfg is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            f.write(cfg.to_json())
    dist.barrier()
    return path


def _is_sharded_dir(d: str) -> bool:
    return os.path.exists(os.path.join(d, SHARDED_TREE))


def _load_sharded(d: str, template, like, cfg):
    """Read a sharded tree: onto the template's DTensor placements (a
    moment onto its param's), or whole tensors where there is no mesh; in
    the template leaf's dtype and device, or as saved without a template."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader

    with open(os.path.join(d, SHARDED_TREE)) as f:
        skel = json.load(f)
    meta = FileSystemReader(d).read_metadata().state_dict_metadata
    want = {} if template is None else {p: x for p, x in tree_leaves_with_path(template)
                                        if isinstance(x, torch.Tensor)}
    names = []
    _rebuild(skel, names.append)
    if template is not None and set(names) != set(want):
        raise ValueError(f"{d} does not hold the template's tensors: "
                         f"{sorted(set(names) ^ set(want))[:8]}")
    state, plans = {}, {}
    for name in names:
        tmpl = want.get(name)
        ref = like.get(_param_of(name, like))
        keys = [name] if name in meta else sorted(
            (k for k in meta if k.startswith(name + "#")), key=lambda k: int(k.split("#")[1]))
        if not keys:
            raise ValueError(f"{d} holds no tensor for {name!r}")
        segs = [tuple(meta[k].size) for k in keys]
        for k, shape in zip(keys, segs):
            dtype = meta[k].properties.dtype
            if ref is not None:  # onto the mesh: this rank's block of the saved tensor
                local_shape = _local_shape(shape, ref)
                state[k] = _as_dtensor(torch.empty(local_shape, dtype=dtype,
                                                   device=_device_of(ref)), ref, shape)
            else:
                state[k] = torch.empty(shape, dtype=dtype,
                                       device="cpu" if tmpl is None else tmpl.device)
        plans[name] = (keys, tmpl, ref)
    dcp.load(state, checkpoint_id=d, no_dist=not dist.is_initialized())

    def leaf(name):
        keys, tmpl, ref = plans[name]
        parts = [state[k].to_local() if _is_dtensor(state[k]) else state[k] for k in keys]
        x = parts[0] if len(parts) == 1 else torch.cat(parts, -1)
        if tmpl is not None:
            x = x.to(dtype=tmpl.dtype)
        if ref is not None and _is_dtensor(tmpl):
            return _as_dtensor(x.contiguous(), ref, tmpl.shape)
        return x

    return _rebuild(skel, leaf)


def _device_of(ref) -> torch.device:
    return ref.to_local().device


def _local_shape(shape, ref):
    """The shape of this rank's block of a tensor of `shape` under ref's placements."""
    shape = list(shape)
    sizes = sharding_mod.axis_sizes(ref.device_mesh)
    for ax, d in zip(ref.device_mesh.mesh_dim_names, ref.placements):
        if d.is_shard():
            shape[d.dim] //= sizes[ax]
    return tuple(shape)


def _place(tree, template, like, cfg):
    """A whole tree read from a one-process checkpoint, placed as the
    mesh's template is: each leaf's (or moment's param's) block."""
    tmpls = dict(tree_leaves_with_path(template))

    def one(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        ref = like.get(_param_of(path, like))
        tmpl = tmpls.get(path)
        if ref is None:
            return x if tmpl is None else x.to(tmpl.device, tmpl.dtype)
        sizes = sharding_mod.axis_sizes(ref.device_mesh)
        coords = {n: ref.device_mesh.get_local_rank(n) for n in ref.device_mesh.mesh_dim_names}
        segs = sharding_mod.fused_segments(_param_of(path, like), cfg) if cfg else None
        local = sharding_mod.local_chunk(x, sharding_mod.spec_of(ref), sizes, coords, segs)
        local = local.to(_device_of(ref), tmpl.dtype if tmpl is not None else x.dtype)
        local = local.contiguous().clone()
        return _as_dtensor(local, ref, x.shape) if _is_dtensor(tmpl) else local

    return tree_map_with_path(one, tree)


# ------------------------------------------------------------------ public


def save_checkpoint(path: str, params: Dict, cfg: Optional[TEOChatConfig] = None,
                    opt_state: Any = None, step: Optional[int] = None) -> str:
    """Save params (+ optional optimizer state) under path[/checkpoint-step].
    Both subdirectories are cleared first, so a save without `opt_state`
    over an earlier checkpoint of the same step leaves none behind. Params
    of DTensors (a mesh) are written sharded, every rank taking part."""
    if step is not None:
        path = os.path.join(path, f"checkpoint-{step}")
    if _on_mesh(params):
        return _save_sharded(path, params, cfg, opt_state)
    os.makedirs(path, exist_ok=True)
    for sub in ("params", "opt_state"):
        shutil.rmtree(os.path.join(path, sub), ignore_errors=True)
    for sub, tree in (("params", params), ("opt_state", opt_state)):
        if tree is not None:
            os.makedirs(os.path.join(path, sub))
            _write_tree(os.path.join(path, sub, TREE_FILE), tree)
    if cfg is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            f.write(cfg.to_json())
    return path


def load_checkpoint(path: str, restore_opt: bool = False,
                    params_template: Any = None, opt_template: Any = None,
                    ) -> Tuple[Dict, Optional[TEOChatConfig], Any]:
    """Restore a checkpoint: (params, config or None, optimizer state or
    None). Without templates the tensors come back on the CPU as saved.
    Either format loads on either topology: templates of DTensors (a mesh)
    get their own blocks, an optimizer template's moments their params'."""
    cfg = None
    cfg_file = os.path.join(path, "config.json")
    if os.path.exists(cfg_file):
        with open(cfg_file) as f:
            cfg = TEOChatConfig.from_json(f.read())
    like = {} if params_template is None else {
        p: x for p, x in tree_leaves_with_path(params_template) if _is_dtensor(x)}

    def read(sub, template):
        d = os.path.join(path, sub)
        if _is_sharded_dir(d):
            return _load_sharded(d, template, like, cfg)
        if not like:
            return _read_tree(os.path.join(d, TREE_FILE), template)
        return _place(_read_tree(os.path.join(d, TREE_FILE)), template, like, cfg)

    params = read("params", params_template)
    opt_state = None
    opt_dir = os.path.join(path, "opt_state")
    if restore_opt and (_is_sharded_dir(opt_dir) or os.path.exists(os.path.join(opt_dir, TREE_FILE))):
        opt_state = read("opt_state", opt_template)
    return params, cfg, opt_state


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """Newest checkpoint-* subdir, or None (auto-resume, train.py:1109-1112)."""
    if not os.path.isdir(output_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(output_dir):
        m = re.match(r"^checkpoint-(\d+)$", name)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(output_dir, name), int(m.group(1))
    return best
