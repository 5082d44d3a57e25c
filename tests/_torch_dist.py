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
from teochat_torch.utils import tree_leaves_with_path, tree_map

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


def rows_plan(cfg: TEOChatConfig, rows: List[Dict], pad_to: Optional[int] = None):
    """(FusionPlan, pixels [N, 3, H, W] fp32) of a list of rows, each
    {'ids', 'labels', 'frames'}: one plan padded to its longest row, or to
    `pad_to` (a length the `sequence` axis divides, as the collator's
    buckets are)."""
    plan = fusion_mod.build_fusion_plan(
        [r["ids"] for r in rows], labels=[r["labels"] for r in rows],
        tokens_per_frame=cfg.vision.num_patches, pad_to=pad_to)
    return plan, torch.from_numpy(np.concatenate([r["frames"] for r in rows]))


def run_cfg_of(cfg: TEOChatConfig, mesh, microbatches: Optional[int] = None) -> TEOChatConfig:
    """The train driver's run config for `mesh` (train.py::_run_cfg): the
    ring's and the pipeline's switches for its sequence and pipe axes."""
    from teochat_torch.config import MeshConfig
    from teochat_torch.parallel.sharding import axis_sizes
    from teochat_torch.train.train import TrainingArguments, _run_cfg

    sizes = {} if mesh is None else axis_sizes(mesh)
    args = TrainingArguments(mesh=MeshConfig(sequence=sizes.get("sequence", 1),
                                             pipe=sizes.get("pipe", 1)),
                             pipeline_microbatches=microbatches)
    return _run_cfg(cfg, args)


def variant_params(variant: Dict, device="cpu") -> Dict:
    return to_torch(variant["params"], device)


def run_steps(variant: Dict, batches: List[List[Dict]], sharded=None, mesh=None,
              record: Optional[Dict] = None, device="cpu", pad_to: Optional[int] = None,
              microbatches: Optional[int] = None):
    """Train `variant` ({'cfg' json, 'params' numpy, 'filter', 'dtype', 'opt'
    kwargs}) one optimizer step a global batch, each plan padded to `pad_to`
    where given. On a mesh each rank takes its rows (its (data, fsdp)
    index's chunk), and a sequence or pipe axis runs the ring or the
    pipeline (`microbatches` a step). Returns (state, losses, sharded);
    `record['sq_norm']` gets the squared norms the clip read and
    `record['grads']` the first step's gradients, whole."""
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
    if record is not None:
        inner_step = optimizer.step
        like = dict(tree_leaves_with_path(params))

        def recorded(leaves, grads, state, sq_norm=None):
            if mesh is None:
                record.setdefault("sq_norm", []).append(
                    float(sum(g.float().pow(2).sum() for g in grads.values())))
            if "grads" not in record:
                record["grads"] = _whole_grads(grads, like, cfg, mesh is not None)
            return inner_step(leaves, grads, state, sq_norm)

        optimizer.step = recorded
    state = trainer_mod.init_train_state(params, optimizer, filt)
    step = trainer_mod.make_train_step(run_cfg_of(cfg, mesh, microbatches), optimizer,
                                       trainable_filter=filt, remat=True, sharded=sharded)
    dtype = getattr(torch, variant["dtype"])
    losses = []
    for rows in batches:
        if sharded is not None:
            k = len(rows) // sharded.row_count
            rows = rows[sharded.row_rank * k:(sharded.row_rank + 1) * k]
        plan, pixels = rows_plan(cfg, rows, pad_to)
        state, loss = step(state, plan, pixels.to(device, dtype))
        losses.append(float(loss))
    return state, losses, sharded


def _whole_grads(grads, like, cfg, on_mesh: bool) -> Dict[str, np.ndarray]:
    """{path: the gradient whole, fp32 numpy}; on a mesh each local shard
    is gathered with its leaf's placements (every rank takes part)."""
    from teochat_torch.checkpoint.orbax_io import _as_dtensor
    from teochat_torch.parallel.sharding import unshard

    out = {}
    for path, g in grads.items():
        if on_mesh:
            g = unshard(_as_dtensor(g.contiguous(), like[path]), path, cfg)
        out[path] = g.detach().float().cpu().numpy().copy()
    return out


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


def scenario_context_pipe(setup, out_dir, rank):
    """setup['cp_variants'] on each sequence / pipe mesh of this world
    (setup['cp_runs']: (mesh shape of 5, microbatches, variant names)),
    plans padded to setup['pad_to']: losses, the first step's gradients,
    the trees whole; on the first pipe mesh a sharded save of the first
    variant."""
    from teochat_torch.checkpoint import orbax_io

    world = torch.distributed.get_world_size()
    saved = False
    for shape, mb, names in setup["cp_runs"]:
        if int(np.prod(shape)) != world:
            continue
        mesh = _mesh(shape)
        tag = "".join(map(str, shape)) + f"_m{mb}"
        for name in names:
            variant = setup["cp_variants"][name]
            cfg = TEOChatConfig.from_json(variant["cfg"])
            record = {}
            state, losses, _ = run_steps(variant, setup["batches"], mesh=mesh, record=record,
                                         pad_to=setup["pad_to"], microbatches=mb)
            if shape[4] > 1 and not saved:
                orbax_io.save_checkpoint(os.path.join(out_dir, f"ckpt_{name}_{tag}"),
                                         state.params, cfg, opt_state=state.opt_state, step=3)
                saved = True
            full = full_tree(state.params, cfg)
            if rank == 0:
                torch.save({"losses": losses, "params": full, **record},
                           os.path.join(out_dir, f"cp_{name}_{tag}.pt"))


def scenario_ring(setup, out_dir, rank):
    """Each ring case on this world's `sequence` mesh, through the plain
    twin (context_parallel_attention) and through the kernel path with the
    kernels' tile walks in their place: the output and the q / k / v
    gradients of sum(out * w), whole; the errors of a length the ring does
    not divide and of heads GQA cannot group."""
    import torch.distributed as dist

    from teochat_torch.parallel import ring_attention as ring

    n = dist.get_world_size()
    mesh = _mesh((1, 1, 1, n, 1))
    group = mesh.get_group("sequence")
    out = {}
    for name, case in setup["ring"].items():
        q, k, v = (torch.from_numpy(case[x]).requires_grad_() for x in ("q", "k", "v"))
        w = torch.from_numpy(case["w"])
        own_w = w.chunk(n, 1)[rank]
        for form in ("plain", "walks"):
            if form == "plain":
                o = ring.context_parallel_attention(q, k, v, mesh, causal=case["causal"])
            else:
                o = ring.ring_attention_flash(*(x.chunk(n, 1)[rank] for x in (q, k, v)),
                                              group=group, n=n, rank=rank,
                                              causal=case["causal"],
                                              kernels=ring.schedule_kernels())
            grads = [g.contiguous() for g in torch.autograd.grad((o * own_w).sum(), (q, k, v))]
            for g in grads:
                dist.all_reduce(g)
            whole = [torch.empty_like(o) for _ in range(n)]
            dist.all_gather(whole, o.detach().contiguous())
            out[f"{name}_{form}"] = [torch.cat(whole, 1).numpy()] + [g.numpy() for g in grads]
    errors = {}
    x = torch.zeros(1, 6 * n + 1, 2, 8)
    for name, fn in (("not_divisible", lambda: ring.context_parallel_attention(x, x, x, mesh)),
                     ("heads", lambda: ring.ring_attention(
                         torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 2, 8),
                         torch.zeros(1, 4, 2, 8), group=group, n=n, rank=rank))):
        try:
            fn()
        except ValueError as e:
            errors[name] = str(e)
    if rank == 0:
        torch.save({"out": out, "errors": errors}, os.path.join(out_dir, f"ring_{n}.pt"))


def scenario_pipeline(setup, out_dir, rank):
    """Each pipeline case (setup['pipe']) on this world's `pipe` mesh at each
    microbatch count: the decoder's logits (with its padding mask where the
    case has one) and the gradients of sum(logits * probe) for the input
    and every layer leaf, whole; the shape errors."""
    import dataclasses

    import torch.distributed as dist

    from teochat_torch.checkpoint.orbax_io import _as_dtensor
    from teochat_torch.models import llama as llama_mod
    from teochat_torch.models import mpt as mpt_mod
    from teochat_torch.parallel import Sharded, shard_params
    from teochat_torch.parallel.sharding import unshard

    n = dist.get_world_size()
    mesh = _mesh((1, 1, 1, 1, n))
    out = {}
    for name, case in setup["pipe"].items():
        cfg = TEOChatConfig.from_json(case["cfg"])
        for mb in case["microbatches"]:
            llm_cfg = dataclasses.replace(cfg.llm, pipeline_axis="pipe", pipeline_microbatches=mb)
            params = shard_params({"llm": to_torch(case["llm"], "cpu")}, mesh, cfg)
            sh = Sharded(mesh, cfg, params)
            llm = sh.local(params)["llm"]
            leaves = {p: x.requires_grad_() for p, x in tree_leaves_with_path(llm["layers"])}
            x = torch.from_numpy(case["x"]).requires_grad_()
            mask = None if case["mask"] is None else torch.from_numpy(case["mask"])
            if mpt_mod.is_mpt_params(llm):
                logits = mpt_mod.mpt_forward(llm, llm_cfg, x, attention_mask=mask,
                                             right_padded=mask is None, remat=True, sharded=sh)
            else:
                logits = llama_mod.llama_forward(
                    llm, llm_cfg, x, position_ids=torch.from_numpy(case["pos"]),
                    attention_mask=mask, right_padded=mask is None, remat=True, sharded=sh)
            got = torch.autograd.grad((logits * torch.from_numpy(case["probe"])).sum(),
                                      [x, *leaves.values()], allow_unused=True)
            dx = got[0] if got[0] is not None else torch.zeros_like(x)
            dist.all_reduce(dx)  # stage 0's: the others' are zero
            like = dict(tree_leaves_with_path(params))
            grads = {p: unshard(_as_dtensor(g.contiguous(), like[f"llm/layers/{p}"]),
                                f"llm/layers/{p}", cfg).numpy()
                     for p, g in zip(leaves, got[1:])}
            out[f"{name}_m{mb}"] = {"logits": logits.detach().numpy(), "dx": dx.numpy(),
                                    "grads": grads}
    # the shape errors: 3 layers over the stages, a batch of 4 in 3 microbatches
    case = setup["pipe"]["llama"]
    cfg = TEOChatConfig.from_json(case["cfg"])
    llm = to_torch(case["llm"], "cpu")
    odd = {**llm, "layers": tree_map(lambda t: t[:3], llm["layers"])}
    errors = {}
    for key, tree, llm_cfg in (
            ("layers", odd, dataclasses.replace(cfg.llm, num_layers=3, pipeline_axis="pipe")),
            ("batch", llm, dataclasses.replace(cfg.llm, pipeline_axis="pipe",
                                               pipeline_microbatches=3))):
        params = shard_params({"llm": tree}, mesh, cfg)
        sh = Sharded(mesh, cfg, params)
        try:
            llama_mod.llama_forward(sh.local(params)["llm"], llm_cfg, torch.from_numpy(case["x"]),
                                    position_ids=torch.from_numpy(case["pos"]),
                                    right_padded=True, sharded=sh)
        except ValueError as e:
            errors[key] = str(e)
    if rank == 0:
        torch.save({"out": out, "errors": errors}, os.path.join(out_dir, f"pipe_{n}.pt"))


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
