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
"""

from __future__ import annotations

import json
import os
import re
import shutil
import struct
from typing import Any, Dict, Optional, Tuple

import torch

from teochat_torch.config import TEOChatConfig
from teochat_torch.utils import tree_leaves_with_path

TREE_FILE = "tree.safetensors"
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


def save_checkpoint(path: str, params: Dict, cfg: Optional[TEOChatConfig] = None,
                    opt_state: Any = None, step: Optional[int] = None) -> str:
    """Save params (+ optional optimizer state) under path[/checkpoint-step].
    Both subdirectories are cleared first, so a save without `opt_state`
    over an earlier checkpoint of the same step leaves none behind."""
    if step is not None:
        path = os.path.join(path, f"checkpoint-{step}")
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
    None). Without templates the tensors come back on the CPU as saved."""
    params = _read_tree(os.path.join(path, "params", TREE_FILE), params_template)
    cfg = None
    cfg_file = os.path.join(path, "config.json")
    if os.path.exists(cfg_file):
        with open(cfg_file) as f:
            cfg = TEOChatConfig.from_json(f.read())
    opt_state = None
    opt_file = os.path.join(path, "opt_state", TREE_FILE)
    if restore_opt and os.path.exists(opt_file):
        opt_state = _read_tree(opt_file, opt_template)
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
