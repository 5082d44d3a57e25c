"""Ranks of the port's mesh as gloo processes on the CPU, for the tests.

`launch(world, out_dir, scenarios)` starts `world` processes of this module
(`python -m tests._torch_dist OUT_DIR SCENARIO...`, each with RANK and
WORLD_SIZE in its environment and one thread), which join one gloo group
through a `file://` rendezvous in OUT_DIR, run the scenarios in order and
write what they found under OUT_DIR; it returns when all have exited and
raises with their output if any failed. The ranks import torch and the port
only. Their inputs are `setup.pt` in OUT_DIR, which the test writes (numpy
trees and batches, read back with `weights_only=False`: this file is the
test's own).

`run_steps` is the training both sides run: the ranks on a mesh, the test
on one process over the same global batches.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from teochat_torch.checkpoint.bridge import to_torch
from teochat_torch.config import TEOChatConfig
from teochat_torch.models import fusion as fusion_mod
from teochat_torch.train import lora as lora_mod
from teochat_torch.train import trainer as trainer_mod
from teochat_torch.utils import tree_leaves_with_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILTERS = {
    "lora": lora_mod.lora_trainable_filter,
    "full": None,
    "projector": lambda p: "projector" in p,
}


def launch(world: int, out_dir: str, scenarios: List[str], timeout: float = 300.0) -> None:
    """Run `scenarios` on `world` gloo ranks; raise with the ranks' output
    if one fails or the run outlasts `timeout` seconds."""
    init = os.path.join(out_dir, "init")
    if os.path.exists(init):
        os.remove(init)
    procs = []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world),
               "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO + os.pathsep
               + os.environ.get("PYTHONPATH", "")}
        log = open(os.path.join(out_dir, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "tests._torch_dist", out_dir, *scenarios],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    failed = []
    try:
        for rank, (p, log) in enumerate(procs):
            try:
                rc = p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                failed.append((rank, rc))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if failed:
        logs = "\n".join(open(os.path.join(out_dir, f"rank{r}.log")).read()[-4000:]
                         for r, _ in failed)
        raise RuntimeError(f"ranks {failed} failed:\n{logs}")


# ------------------------------------------------------------------ inputs


def rows_plan(cfg: TEOChatConfig, rows: List[Dict]):
    """(FusionPlan, pixels [N, 3, H, W] fp32) of a list of rows, each
    {'ids', 'labels', 'frames'}: one plan padded to its longest row."""
    plan = fusion_mod.build_fusion_plan(
        [r["ids"] for r in rows], labels=[r["labels"] for r in rows],
        tokens_per_frame=cfg.vision.num_patches)
    return plan, torch.from_numpy(np.concatenate([r["frames"] for r in rows]))


def variant_params(variant: Dict, device="cpu") -> Dict:
    return to_torch(variant["params"], device)


def run_steps(variant: Dict, batches: List[List[Dict]], sharded=None, mesh=None,
              record: Optional[Dict] = None, device="cpu"):
    """Train `variant` ({'cfg' json, 'params' numpy, 'filter', 'dtype', 'opt'
    kwargs}) one optimizer step a global batch. On a mesh each rank takes
    its rows (its (data, fsdp) index's chunk). Returns (state, losses,
    sharded); `record['sq_norm']` gets the squared norms the clip read."""
    from teochat_torch.parallel import Sharded, shard_params

    cfg = TEOChatConfig.from_json(variant["cfg"])
    filt = FILTERS[variant["filter"]]
    params = trainer_mod.fp32_masters(variant_params(variant, device), filt)
    if mesh is not None:
        params = shard_params(params, mesh, cfg)
        sharded = Sharded(mesh, cfg, params)
        if record is not None:
            inner = sharded.global_sq_norm

            def norm(grads):
                out = inner(grads)
                record.setdefault("sq_norm", []).append(float(out))
                return out

            sharded.global_sq_norm = norm
    optimizer = trainer_mod.make_optimizer(**variant["opt"])
    if mesh is None and record is not None:
        inner_step = optimizer.step

        def recorded(params, grads, state, sq_norm=None):
            record.setdefault("sq_norm", []).append(
                float(sum(g.float().pow(2).sum() for g in grads.values())))
            return inner_step(params, grads, state, sq_norm)

        optimizer.step = recorded
    state = trainer_mod.init_train_state(params, optimizer, filt)
    step = trainer_mod.make_train_step(cfg, optimizer, trainable_filter=filt, remat=True,
                                       sharded=sharded)
    dtype = getattr(torch, variant["dtype"])
    losses = []
    for rows in batches:
        if sharded is not None:
            k = len(rows) // sharded.row_count
            rows = rows[sharded.row_rank * k:(sharded.row_rank + 1) * k]
        plan, pixels = rows_plan(cfg, rows)
        state, loss = step(state, plan, pixels.to(device, dtype))
        losses.append(float(loss))
    return state, losses, sharded


def full_tree(params, cfg) -> Dict[str, np.ndarray]:
    """{path: the leaf whole, as numpy} of a DTensor tree (every rank gathers)."""
    from teochat_torch.parallel.sharding import unshard

    return {p: unshard(x, p, cfg).float().cpu().numpy().copy()
            for p, x in tree_leaves_with_path(params)}


# ------------------------------------------------------------------ scenarios


def _mesh(shape):
    from teochat_torch.config import MeshConfig
    from teochat_torch.parallel import create_mesh

    return create_mesh(MeshConfig(*shape), "cpu")


def scenario_train(setup, out_dir, rank):
    """Each variant on each of the setup's meshes for this world: losses,
    the trained tree whole, the clip's squared norms; and the sharded
    logits of the setup's forward checks."""
    world = torch.distributed.get_world_size()
    for shape in [s for s in setup["meshes"] if int(np.prod(s)) == world]:
        mesh = _mesh(shape)
        tag = "".join(map(str, shape))
        for name, variant in setup["variants"].items():
            record = {}
            state, losses, _ = run_steps(variant, setup["batches"], mesh=mesh, record=record)
            cfg = TEOChatConfig.from_json(variant["cfg"])
            full = full_tree(state.params, cfg)
            if rank == 0:
                torch.save({"losses": losses, "params": full, **record},
                           os.path.join(out_dir, f"train_{name}_{tag}.pt"))
        for name, check in setup.get("forward", {}).items():
            logits = sharded_logits(check, mesh)
            if rank == 0:
                torch.save(logits, os.path.join(out_dir, f"logits_{name}_{tag}.pt"))


def sharded_logits(check: Dict, mesh) -> np.ndarray:
    """The decoder's cache-free logits on the mesh ({'cfg', 'llm' numpy,
    'embeds', 'mask'}), whole on every rank."""
    from teochat_torch.models import llama as llama_mod
    from teochat_torch.models import mpt as mpt_mod
    from teochat_torch.parallel import Sharded, shard_params

    cfg = TEOChatConfig.from_json(check["cfg"])
    params = shard_params({"llm": to_torch(check["llm"], "cpu")}, mesh, cfg)
    sh = Sharded(mesh, cfg, params)
    local = sh.local(params)["llm"]
    embeds = torch.from_numpy(check["embeds"])
    mask = torch.from_numpy(check["mask"])
    with torch.no_grad():
        if mpt_mod.is_mpt_params(local):
            out = mpt_mod.mpt_forward(local, cfg.llm, embeds, attention_mask=mask,
                                      right_padded=True, sharded=sh)
        else:
            pos = torch.arange(embeds.shape[1])[None].expand(embeds.shape[0], -1)
            out = llama_mod.llama_forward(local, cfg.llm, embeds, position_ids=pos,
                                          attention_mask=mask, right_padded=True, sharded=sh)
    return out.numpy()


def scenario_save(setup, out_dir, rank):
    """The checkpoint variant on the save mesh: periodic saves (with the
    optimizer state) at steps 1 and 2, pruned to the newest; a final save
    (without it) over a periodic one of the same step in another directory
    (F7); the step-2 trees whole, for the test to hold the loads to."""
    from teochat_torch.checkpoint import orbax_io
    from teochat_torch.train.train import _prune_checkpoints

    ck = setup["checkpoint"]
    mesh = _mesh(ck["save_mesh"])
    variant = setup["variants"][ck["variant"]]
    cfg = TEOChatConfig.from_json(variant["cfg"])
    out, final = os.path.join(out_dir, "ckpt"), os.path.join(out_dir, "ckpt_final")
    state, losses, _ = run_steps(variant, setup["batches"][:1], mesh=mesh)
    orbax_io.save_checkpoint(out, state.params, cfg, opt_state=state.opt_state, step=1)
    state, more = _more_steps(state, variant, setup["batches"][1:2], mesh)
    orbax_io.save_checkpoint(out, state.params, cfg, opt_state=state.opt_state, step=2)
    if rank == 0:
        _prune_checkpoints(out, 1)
    orbax_io.save_checkpoint(final, state.params, cfg, opt_state=state.opt_state, step=2)
    orbax_io.save_checkpoint(final, state.params, cfg, step=2)
    params, opt = full_tree(state.params, cfg), _opt_whole(state, cfg)
    if rank == 0:
        torch.save({"params": params, "opt": opt, "losses": losses + more},
                   os.path.join(out_dir, "saved.pt"))


def _more_steps(state, variant, batches, mesh):
    """Steps over `batches` from a state on `mesh` (a resume's)."""
    from teochat_torch.parallel import Sharded

    cfg = TEOChatConfig.from_json(variant["cfg"])
    filt = FILTERS[variant["filter"]]
    sharded = Sharded(mesh, cfg, state.params)
    step = trainer_mod.make_train_step(cfg, trainer_mod.make_optimizer(**variant["opt"]),
                                       trainable_filter=filt, remat=True, sharded=sharded)
    losses = []
    for rows in batches:
        k = len(rows) // sharded.row_count
        plan, pixels = rows_plan(cfg, rows[sharded.row_rank * k:(sharded.row_rank + 1) * k])
        state, loss = step(state, plan, pixels.to(getattr(torch, variant["dtype"])))
        losses.append(float(loss))
    return state, losses


def scenario_load(setup, out_dir, rank):
    """The saved checkpoint on the load mesh: its trees whole (for a bitwise
    comparison), then a resume of one step; and the test's one-process
    checkpoint (OUT_DIR/one_ckpt) on the same mesh, its trees whole."""
    from teochat_torch.checkpoint import orbax_io
    from teochat_torch.parallel import shard_params

    ck = setup["checkpoint"]
    mesh = _mesh(ck["load_mesh"])
    variant = setup["variants"][ck["variant"]]
    cfg = TEOChatConfig.from_json(variant["cfg"])
    filt = FILTERS[variant["filter"]]
    params = shard_params(trainer_mod.fp32_masters(variant_params(variant), filt), mesh, cfg)
    template = trainer_mod.init_train_state(
        params, trainer_mod.make_optimizer(**variant["opt"]), filt)
    resume = orbax_io.latest_checkpoint(os.path.join(out_dir, "ckpt"))
    params, _, opt = orbax_io.load_checkpoint(resume, restore_opt=True,
                                              params_template=template.params,
                                              opt_template=template.opt_state)
    state = trainer_mod.TrainState(params, opt, 2)
    loaded = {"params": full_tree(params, cfg), "opt": _opt_whole(state, cfg)}
    # a one-process checkpoint (the test's) onto this mesh
    one_params, _, one_opt = orbax_io.load_checkpoint(
        os.path.join(out_dir, "one_ckpt", "checkpoint-2"), restore_opt=True,
        params_template=template.params, opt_template=template.opt_state)
    from_one = {"params": full_tree(one_params, cfg),
                "opt": _opt_whole(trainer_mod.TrainState(one_params, one_opt, 2), cfg)}
    state, losses = _more_steps(state, variant, setup["batches"][2:3], mesh)
    resumed = full_tree(state.params, cfg)
    if rank == 0:
        torch.save({**loaded, "resume": resumed, "losses": losses, "from": resume,
                    "from_one": from_one}, os.path.join(out_dir, "loaded.pt"))


def scenario_rounding(setup, out_dir, rank):
    """Row-parallel projections in bf16 on mesh (1, 1, 2) against one
    device's: an int8 kernel, the same with LoRA, a bf16 kernel. Each rank
    holds half of x's columns and of the kernel's rows; the share of output
    elements bitwise equal to one device's (which rounds its fp32 sum once)."""
    from teochat_torch.models import llama as llama_mod
    from teochat_torch.ops.quant import quantize_kernel
    from teochat_torch.parallel import Sharded

    if torch.distributed.get_world_size() != 2:
        return
    mesh = _mesh((1, 1, 2))
    sh = Sharded(mesh, TEOChatConfig(), {})
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 16, 256, generator=gen).bfloat16()
    w = torch.randn(256, 192, generator=gen) * 0.05
    lora = {"lora_a": torch.randn(256, 8, generator=gen) * 0.3,
            "lora_b": torch.randn(8, 192, generator=gen) * 0.3,
            "lora_scale": torch.tensor(2.0)}
    cases = {"int8": quantize_kernel(w), "int8_lora": {**quantize_kernel(w), **lora},
             "bf16": {"kernel": w.bfloat16()}}
    shares = {}
    for name, p in cases.items():
        want = llama_mod._proj(x, p)
        local = {k: v.chunk(2, 0)[rank] if k == "kernel" else
                 v.chunk(2, -1)[rank] if k == "lora_b" else v for k, v in p.items()}
        got = sh.row_proj(x.chunk(2, -1)[rank], local)
        shares[name] = (got == want).float().mean().item()
    if rank == 0:
        torch.save(shares, os.path.join(out_dir, "rounding.pt"))


def _opt_whole(state, cfg) -> Dict[str, np.ndarray]:
    """The optimizer's moments whole ({'mu/<path>': ...}), every rank gathering."""
    from torch.distributed.tensor import DTensor

    from teochat_torch.checkpoint.orbax_io import _as_dtensor, _param_of
    from teochat_torch.parallel.sharding import unshard

    like = {p: x for p, x in tree_leaves_with_path(state.params) if isinstance(x, DTensor)}
    out = {}
    for path, x in tree_leaves_with_path(state.opt_state):
        if isinstance(x, torch.Tensor):
            param = _param_of(path, like)
            out[path] = unshard(_as_dtensor(x, like[param]), param, cfg).cpu().numpy().copy()
    return out


def main(argv) -> None:
    import torch.distributed as dist

    out_dir, scenarios = argv[0], argv[1:]
    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(out_dir, 'init')}",
                            rank=rank, world_size=world)
    try:
        setup = torch.load(os.path.join(out_dir, "setup.pt"), weights_only=False)
        for name in scenarios:
            globals()[f"scenario_{name}"](setup, out_dir, rank)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
