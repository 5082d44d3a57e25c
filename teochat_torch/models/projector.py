"""Vision-language projector (port of teochat_tpu/models/projector.py).

`linear` | `mlp{N}x_gelu` | `identity`; TEOChat uses mlp2x_gelu:
Linear(1024 -> 4096), exact GELU, Linear(4096 -> 4096).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from teochat_torch.config import ProjectorConfig

Params = Dict


def projector_forward(params: Params, cfg: ProjectorConfig, x: torch.Tensor,
                      sharded=None) -> torch.Tensor:
    """[..., mm_hidden] -> [..., hidden]; exact (erf) GELU between layers.
    `sharded`: on the mesh each kernel is gathered whole (its fsdp dim,
    then its model columns) and every rank runs the projector the same."""
    if cfg.depth == 0:
        return x
    for i, lp in enumerate(params["layers"]):
        if sharded is not None:
            lp = sharded.gather(lp, f"projector/layers/{i}")
            lp = {**lp, "kernel": sharded.gather_model(lp["kernel"], -1)
                  if "model" in sharded.specs[f"projector/layers/{i}/kernel"] else lp["kernel"]}
        if i > 0:
            x = F.gelu(x)
        x = torch.matmul(x, lp["kernel"].to(x.dtype)) + lp["bias"].to(x.dtype)
    return x
