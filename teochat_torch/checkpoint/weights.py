"""Weight-management utilities (port of teochat_tpu/checkpoint/weights.py).

On the port's checkpoints (checkpoint/orbax_io.py: one process's safetensors
trees or a mesh's sharded ones, both read whole here):
- `merge_lora_weights`: fold a checkpoint's LoRA adapters into its kernels
  and save it standalone (reference scripts/merge_lora_weights.py:11-31);
- `make_delta` / `apply_delta`: target - base and base + delta, leaf by
  leaf (reference model/make_delta.py:13-41, model/apply_delta.py:13-37);
- `consolidate_ckpt`: re-save a checkpoint whole with its config, a missing
  one upgraded to the default TEOChatConfig (reference consolidate.py:14-19
  + model/utils.py:4-22);
- `collect_upload_files` / `upload_weights`: the files a hub push ships (the
  checkpoint tree and the tokenizer's files, by repo-relative name), handed
  to an injected `transport(repo_id, files, private)`. The default transport
  names `huggingface_hub` and needs a network this code never assumes: the
  tests inject theirs, and nothing is sent otherwise.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import torch

from teochat_torch.checkpoint.orbax_io import load_checkpoint, save_checkpoint
from teochat_torch.config import TEOChatConfig
from teochat_torch.train.lora import merge_lora
from teochat_torch.utils import tree_leaves_with_path, tree_map_with_path


def merge_lora_weights(model_path: str, save_path: str) -> str:
    """Load a checkpoint with LoRA leaves, merge them, save it standalone."""
    params, cfg, _ = load_checkpoint(model_path)
    params = {**params, "llm": merge_lora(params["llm"])}
    return save_checkpoint(save_path, params, cfg)


def _tree_binary(a: Dict, b: Dict, op) -> Dict:
    """op(a's leaf, b's leaf at the same path) over two trees of one structure."""
    flat_a, flat_b = dict(tree_leaves_with_path(a)), dict(tree_leaves_with_path(b))
    if flat_a.keys() != flat_b.keys():
        raise ValueError(f"trees differ in their leaves: {sorted(flat_a.keys() ^ flat_b.keys())[:8]}")
    return tree_map_with_path(
        lambda p, x: op(torch.as_tensor(x), torch.as_tensor(flat_b[p])), a)


def make_delta(base_params: Dict, target_params: Dict) -> Dict:
    """delta = target - base (reference make_delta.py:13-41)."""
    return _tree_binary(target_params, base_params, lambda t, b: t - b)


def apply_delta(base_params: Dict, delta_params: Dict) -> Dict:
    """target = base + delta (reference apply_delta.py:13-37)."""
    return _tree_binary(base_params, delta_params, lambda b, d: b + d)


def consolidate_ckpt(src_path: str, dst_path: str) -> str:
    """Re-save a checkpoint in one-process form with an upgraded config
    (reference consolidate.py:14-19 + auto_upgrade, model/utils.py:4-22)."""
    params, cfg, _ = load_checkpoint(src_path)
    return save_checkpoint(dst_path, params, cfg or TEOChatConfig())


_TOKENIZER_FILES = (
    # what AutoTokenizer.push_to_hub ships for a LLaMA / sentencepiece tokenizer
    "tokenizer.model",
    "tokenizer.json",
    "tokenizer_config.json",
    "special_tokens_map.json",
    "added_tokens.json",
)


def collect_upload_files(model_path: str, tokenizer_path: Optional[str] = None
                         ) -> Dict[str, str]:
    """Repo-relative names -> local paths of everything a hub push ships:
    every file under the checkpoint directory, and the tokenizer files of
    `tokenizer_path` that exist (reference scripts/upload_weights.py:15-28)."""
    if not os.path.isdir(model_path):
        raise FileNotFoundError(f"checkpoint directory not found: {model_path}")
    files: Dict[str, str] = {}
    for root, _, names in os.walk(model_path):
        for name in names:
            local = os.path.join(root, name)
            files[os.path.relpath(local, model_path).replace(os.sep, "/")] = local
    if not files:
        raise FileNotFoundError(f"checkpoint directory is empty: {model_path}")
    if tokenizer_path is not None:
        for name in _TOKENIZER_FILES:
            local = os.path.join(tokenizer_path, name)
            if os.path.exists(local):
                files[name] = local
    return files


def _hf_hub_transport(repo_id: str, files: Dict[str, str], private: bool) -> None:
    """The default transport: huggingface_hub, on a machine with a network."""
    try:
        from huggingface_hub import HfApi
    except ImportError as e:
        raise RuntimeError(
            "hub upload needs huggingface_hub (and a network); copy the checkpoint "
            "directory and push from a networked machine, or pass transport="
        ) from e
    api = HfApi()
    api.create_repo(repo_id, private=private, exist_ok=True)
    for rel, local in sorted(files.items()):
        api.upload_file(path_or_fileobj=local, path_in_repo=rel, repo_id=repo_id)


def upload_weights(model_path: str, repo_id: str, *, tokenizer_path: Optional[str] = None,
                   private: bool = False,
                   transport: Optional[Callable[[str, Dict[str, str], bool], None]] = None,
                   ) -> Dict[str, str]:
    """Push a checkpoint (and its tokenizer) to a model hub repo: the files
    of `collect_upload_files`, handed to `transport(repo_id, files,
    private)` (the default: huggingface_hub). Returns the file map."""
    files = collect_upload_files(model_path, tokenizer_path)
    (transport or _hf_hub_transport)(repo_id, files, private)
    return files
