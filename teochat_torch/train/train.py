"""Train driver (port of teochat_tpu/train/train.py).

The TEOChat fine-tuning recipe on one CUDA device, on a mesh of them
(below) or on the CPU, rebuilt from reference
videollava/train/train.py:915-1134 + llava_trainer.py as the JAX driver has
it: HfArgumentParser-style dataclass configs, the model loaded
through the builder (`allow_partial`, then `initialize_vision_modules`
attaches a missing tower or projector), the trainable set (LoRA r=128 /
alpha=256 on every decoder projection over a frozen, optionally int8,
backbone; the projector alone; or full fine-tuning), the trainable leaves
as fp32 masters, the projector in its own learning-rate group, AdamW +
warmup + cosine, gradient accumulation, decoder-layer remat,
modality-grouped batching, a prefetch thread, tensorboard / wandb writers
where installed, checkpoints every `save_steps` pruned to
`save_total_limit`, auto-resume from the newest `checkpoint-*` and a final
save.

As in the JAX driver: the final save writes no optimizer state, so a final
save at a step just saved periodically replaces that checkpoint without
its `opt_state` (ROADMAP F7); a resume restarts the epoch's data order
from its first batch (F8).

With `mm_use_im_patch_token` / `mm_use_im_start_end` the vision tokens are
added to a tokenizer that can grow and the embeddings resized
(vision_tokenizer.py::initialize_vision_tokenizer), and the prompts carry
the `<im_start><image><im_end>` wrap; a projector-only run then trains the
input embeddings too (`embed_trainable_filter`).

The decoder is LLaMA's or LLaVA-MPT's (its params hold the tied `wte`):
LoRA then goes on MPT's four projections and the loss runs the MPT decoder
(models/teochat.py::forward_train). The vision tokenizer resizes LLaMA's
`embed_tokens` only, as JAX's does (ROADMAP F10): an MPT run with
`mm_use_im_patch_token` or `mm_use_im_start_end` and a tokenizer that can
grow raises a ValueError naming it. `mpt_attn_impl` is accepted and
ignored, as in the JAX driver.

On more than one process the run is on the (data, fsdp, model) mesh
(parallel/): the params as DTensors, each rank's rows, the gradients summed
over the row ranks, sharded checkpoints. A `sequence` axis
(`--mesh_sequence`) splits each row's tokens over a ring
(parallel/ring_attention.py), a `pipe` axis (`--mesh_pipe`,
`--pipeline_microbatches`) the layer stack over GPipe stages
(parallel/pipeline.py); as in the JAX driver they switch on
`sequence_axis` / `pipeline_axis` in the config the train step runs
(`run_cfg`) and never in the one checkpoints persist. The ring takes LLaMA
only: JAX's driver fails on LLaVA-MPT there (ROADMAP F11), and the port
raises a ValueError naming it.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from teochat_torch.checkpoint.orbax_io import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from teochat_torch.config import MeshConfig, TEOChatConfig
from teochat_torch.data.dataset import (
    DataArguments,
    make_supervised_data_module,
    set_default_conversation,
)
from teochat_torch.data.sampler import LengthGroupedSampler
from teochat_torch.models.generation import embedding_table
from teochat_torch.models.mpt import is_mpt_params
from teochat_torch.parallel import Sharded, create_mesh, shard_params
from teochat_torch.parallel.tensor_parallel import check_trainable_on_mesh
from teochat_torch.train.lora import add_lora_params, lora_trainable_filter
from teochat_torch.train.trainer import (
    MultiSteps,
    TrainState,
    fp32_masters,
    init_train_state,
    make_optimizer,
    make_train_step,
)
from teochat_torch.utils import is_rank0, rank0_print
from teochat_torch.vision_tokenizer import embed_trainable_filter, initialize_vision_tokenizer


@dataclass
class ModelArguments:
    """Reference ModelArguments (train.py:48-72)."""

    model_name_or_path: Optional[str] = None
    version: str = "v1"
    freeze_backbone: bool = True
    tune_mm_mlp_adapter: bool = False
    freeze_mm_mlp_adapter: bool = False
    # towers attached by initialize_vision_modules when the base LM lacks
    # them (local dirs)
    image_tower: Optional[str] = None
    video_tower: Optional[str] = None
    mm_projector_type: str = "linear"  # train_teochat.sh:14 passes mlp2x_gelu
    mm_vision_select_layer: int = -2
    mm_vision_select_feature: str = "patch"
    pretrain_mm_mlp_adapter: Optional[str] = None
    mm_use_im_start_end: bool = False
    mm_use_im_patch_token: bool = True


@dataclass
class TrainingArguments:
    """Reference TrainingArguments extension (train.py:102-120) + the JAX
    driver's mesh knobs, with the JAX driver's defaults. Knobs that mean
    nothing here are accepted for parity: tf32, optim (AdamW is the only
    optimizer), the bitsandbytes ones, mpt_attn_impl."""

    output_dir: str = "./checkpoints/teochat"
    num_train_epochs: int = 1
    max_steps: Optional[int] = None
    per_device_train_batch_size: int = 4
    gradient_accumulation_steps: int = 1  # train_teochat.sh:26 uses 8
    learning_rate: float = 2e-4
    mm_projector_lr: Optional[float] = 2e-5
    warmup_ratio: float = 0.03
    weight_decay: float = 0.0
    logging_steps: int = 10
    save_steps: int = 2000
    save_total_limit: int = 10
    seed: int = 42
    bf16: bool = True
    lora_enable: bool = True
    lora_r: int = 128
    lora_alpha: float = 256.0
    lora_dropout: float = 0.05  # inert: kept for config parity
    bits: int = 16  # 8 -> int8 backbone under LoRA (k-bit training)
    group_by_modality_length: bool = True
    gradient_checkpointing: bool = True
    mesh: MeshConfig = field(default_factory=lambda: MeshConfig(fsdp=-1))
    pipeline_microbatches: Optional[int] = None
    report_to: str = "tensorboard"
    lr_scheduler_type: str = "cosine"
    max_grad_norm: float = 1.0
    warmup_steps: int = 0  # >0 overrides warmup_ratio (HF semantics)
    model_max_length: Optional[int] = None  # caps cfg.max_sequence_length
    tokenizer_model_max_length: Optional[int] = None  # caps tokenization length
    dataloader_num_workers: int = 0  # >0 -> a prefetch thread this many batches deep
    per_device_eval_batch_size: int = 1
    evaluation_strategy: str = "no"
    save_strategy: str = "steps"  # "no" disables periodic checkpoints
    tf32: bool = True
    optim: str = "adamw_torch"
    cache_dir: Optional[str] = None
    double_quant: bool = True
    quant_type: str = "nf4"
    lora_weight_path: str = ""
    lora_bias: str = "none"
    mpt_attn_impl: str = "triton"


def _make_mesh(mesh: MeshConfig, device: torch.device):
    """The run's mesh (JAX train.py:372-420): a DeviceMesh over the process
    group's ranks when more than one process takes part, else None. An axis
    above 1 on one process has no ranks to split."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world > 1:
        return create_mesh(mesh, device.type)
    for flag, n in (("--mesh_sequence", mesh.sequence), ("--mesh_pipe", mesh.pipe)):
        if n > 1:
            raise ValueError(f"{flag} {n} needs a multi-device runtime (have 1 process: "
                             "torch.distributed, --distributed under torchrun)")
    sizes = {"data": mesh.data, "fsdp": mesh.fsdp, "model": mesh.model}
    if any(n > 1 for n in sizes.values()):
        raise ValueError(f"a mesh of {sizes} needs as many processes (torch.distributed, "
                         "--distributed under torchrun); this run has one")
    return None


def _run_cfg(cfg: TEOChatConfig, training_args: TrainingArguments) -> TEOChatConfig:
    """The config the train step runs (JAX train.py:378-418): the ring's
    `sequence_axis` and the pipeline's `pipeline_axis` /
    `pipeline_microbatches` switched on for this run's mesh, never in `cfg`,
    which checkpoints persist (a checkpoint loads on any topology)."""
    mesh = training_args.mesh
    llm = cfg.llm
    if mesh.sequence > 1:
        llm = dataclasses.replace(llm, sequence_axis="sequence")
    if mesh.pipe > 1:
        llm = dataclasses.replace(llm, pipeline_axis="pipe",
                                  pipeline_microbatches=training_args.pipeline_microbatches)
    return cfg if llm is cfg.llm else dataclasses.replace(cfg, llm=llm)


def _check_sequence_buckets(collator, n: int) -> None:
    """Every length the collator pads a batch to (its buckets, and multiples
    of 512 past them: models/teochat.py::round_to_bucket) must divide by
    the `sequence` axis, as JAX's ring requires; raise its error otherwise,
    never pad in the model."""
    for length in (*collator.seq_buckets, 512):
        if length % n:
            raise ValueError(f"sequence length {length} not divisible by sequence={n}")


def _batches(dataset, collator, sampler: Iterable[int], batch_size: int,
             process_index: int = 0, process_count: int = 1):
    """Per-process batch stream: the sampler emits megabatches split into
    `process_count` consecutive chunks of `batch_size`, and process p owns
    every chunk with index = p (mod process_count), the DistributedSampler
    slicing the reference gets from its launcher (llava_trainer.py:135-148)."""
    buf: List[int] = []
    chunk_i = 0
    for idx in sampler:
        buf.append(idx)
        if len(buf) == batch_size:
            if chunk_i % process_count == process_index:
                yield collator([dataset[i] for i in buf])
            chunk_i += 1
            buf = []


def _prefetch(gen, depth: int):
    """Batches of `gen` collated on a background thread, at most `depth`
    ahead (reference --dataloader_num_workers, train_teochat.sh:39). An
    exception re-raises at the consumer; when the consumer stops early the
    thread ends after at most one more batch."""
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()
    end = object()

    def worker():
        try:
            for item in gen:
                q.put(item)
                if stop.is_set():
                    return
            q.put(end)
        except Exception as e:  # surfaced in the training loop
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while not q.empty():  # unblock a put, so the thread sees `stop`
            q.get_nowait()


def _prune_checkpoints(output_dir: str, keep: int) -> None:
    """Remove all but the newest `keep` checkpoint-* dirs."""
    import re
    import shutil

    ckpts = sorted(
        (int(m.group(1)), os.path.join(output_dir, n))
        for n in os.listdir(output_dir)
        if (m := re.match(r"^checkpoint-(\d+)$", n))
    )
    for _, path in ckpts[:-keep] if keep > 0 else []:
        shutil.rmtree(path, ignore_errors=True)


def _wandb_writer(output_dir: str):
    """SummaryWriter-shaped wandb adapter (add_scalar / close), or None when
    wandb is not installed or cannot start: the loop logs to the console
    either way."""
    try:
        import wandb
    except ImportError:
        rank0_print("report_to=wandb requested but wandb is not installed; "
                    "falling back to console logging")
        return None

    class _W:
        def __init__(self):
            self._run = wandb.init(project="teochat-torch", dir=output_dir, resume="allow")

        def add_scalar(self, tag, value, step):
            wandb.log({tag: value}, step=step)

        def close(self):
            wandb.finish()

    try:
        return _W()
    except Exception as e:  # noqa: BLE001 - no API key, no network
        rank0_print(f"wandb.init failed ({type(e).__name__}: {e}); "
                    "falling back to console logging")
        return None


def _writer(training_args: TrainingArguments):
    if training_args.report_to == "tensorboard":
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return None
        return SummaryWriter(os.path.join(training_args.output_dir, "tb"))
    if training_args.report_to == "wandb":
        return _wandb_writer(training_args.output_dir)
    return None


def trainable_filter_of(model_args: ModelArguments, training_args: TrainingArguments):
    """The trainable set (reference train.py:974-1006, JAX train.py:306-330):
    LoRA's adapters and the projector; the projector alone; the model but
    the tower (`freeze_backbone`); or every leaf (None). A frozen projector
    leaves the set."""
    trainable_filter = None
    if training_args.lora_enable:
        trainable_filter = lora_trainable_filter
    elif model_args.tune_mm_mlp_adapter:
        trainable_filter = lambda p: "projector" in p  # noqa: E731
        if model_args.mm_use_im_start_end:
            # the new tokens' rows train with the adapter; the lm_head stays
            # frozen (reference llava_arch.py:369-374)
            trainable_filter = embed_trainable_filter(trainable_filter)
    elif model_args.freeze_backbone:
        trainable_filter = lambda p: not p.startswith("vision/")  # noqa: E731
    if model_args.freeze_mm_mlp_adapter and trainable_filter is not None:
        base = trainable_filter
        trainable_filter = lambda p: base(p) and "projector" not in p  # noqa: E731
    return trainable_filter


def train(
    model_args: ModelArguments,
    data_args: DataArguments,
    training_args: TrainingArguments,
    *,
    cfg: Optional[TEOChatConfig] = None,
    params: Optional[Dict] = None,
    tokenizer=None,
    dataset=None,
    max_steps_override: Optional[int] = None,
    history: Optional[List[Dict]] = None,
    device=None,
) -> TrainState:
    """Run fine-tuning; returns the final state. cfg / params / tokenizer /
    dataset may be passed in (tests, the smoke); otherwise the model loads
    from `model_args.model_name_or_path` through the builder onto `device`
    (None: the card) and the data through `datasets.load_dataset`.
    `history`, when given, receives one dict per optimizer step: the step,
    its last micro-batch's loss, its wall seconds (synchronised), its valid
    and padded token counts, and the seconds of its periodic save if it
    made one.

    With a process group of more than one rank (`--distributed`) the run is
    on the mesh `training_args.mesh` (JAX train.py:372-420): every rank
    builds the same params from the seed, `shard_params` places them, each
    rank (its (data, fsdp) coordinate) takes its own chunks of the
    sampler's megabatches, the global batch counts the row ranks, and rank
    0 alone prints and writes the files no rank shards (checkpoints:
    checkpoint/orbax_io.py's sharded format)."""
    np.random.seed(training_args.seed)
    set_default_conversation(model_args.version)

    if params is None or cfg is None:
        from teochat_torch.builder import initialize_vision_modules, load_pretrained_model

        tokenizer, model, processors, _ = load_pretrained_model(
            model_args.model_name_or_path, load_8bit=training_args.bits == 8,
            cache_dir=training_args.cache_dir, allow_partial=True, device=device)
        cfg, params = model.cfg, model.params
        del model
        data_args.image_processor = processors["image"]
        if "vision" not in params or "projector" not in params:
            from teochat_torch.data.processing import ImageProcessor

            gen = torch.Generator(device=embedding_table(params["llm"]).device)
            cfg, params = initialize_vision_modules(
                model_args, cfg, params, generator=gen.manual_seed(training_args.seed))
            # the attached tower may change the input geometry
            data_args.image_processor = ImageProcessor(size=cfg.vision.image_size)
    device = embedding_table(params["llm"]).device

    # sequence-length caps (train_teochat.sh:37)
    if training_args.model_max_length or training_args.tokenizer_model_max_length:
        cfg = dataclasses.replace(
            cfg,
            max_sequence_length=training_args.model_max_length or cfg.max_sequence_length,
            tokenizer_model_max_length=training_args.tokenizer_model_max_length
            or cfg.tokenizer_model_max_length,
        )
    # the vision tokens (reference llava_arch.py:348-391 via train.py:1083-1086):
    # added, the embeddings mean-resized, the wrap passed to the data; skipped
    # for a tokenizer that cannot grow (no add_tokens)
    data_args.mm_use_im_start_end = model_args.mm_use_im_start_end
    if tokenizer is not None and hasattr(tokenizer, "add_tokens") and (
            model_args.mm_use_im_start_end or model_args.mm_use_im_patch_token):
        if is_mpt_params(params["llm"]):
            # JAX's initialize_vision_tokenizer reads `embed_tokens`, which
            # MPT's tree does not hold, and fails there (ROADMAP F10)
            raise ValueError(
                "the vision tokenizer (--mm_use_im_patch_token / --mm_use_im_start_end) "
                "resizes LLaMA's embed_tokens and takes no MPT decoder, as in the JAX "
                "driver; pass --mm_use_im_patch_token False --mm_use_im_start_end False")
        pretrain_rows = None
        if model_args.pretrain_mm_mlp_adapter and model_args.mm_use_im_start_end:
            pretrain_rows = torch.load(model_args.pretrain_mm_mlp_adapter, map_location="cpu",
                                       weights_only=True).get("model.embed_tokens.weight")
        cfg, params, _ = initialize_vision_tokenizer(
            model_args, cfg, params, tokenizer, pretrain_embed_rows=pretrain_rows)

    if training_args.mesh.sequence > 1 and is_mpt_params(params["llm"]):
        # JAX's driver replaces MptConfig's sequence_axis, a field it does not
        # have, and fails with a TypeError before its first step (ROADMAP F11)
        raise ValueError(
            f"--mesh_sequence {training_args.mesh.sequence}: ring attention runs the LLaMA "
            "decoder only; LLaVA-MPT has no sequence_axis, as in the JAX driver. Use "
            "--mesh_pipe, --mesh_fsdp or --mesh_model for MPT")
    trainable_filter = trainable_filter_of(model_args, training_args)
    if training_args.lora_enable:
        gen = torch.Generator(device=device).manual_seed(training_args.seed)
        params = {**params, "llm": add_lora_params(
            gen, params["llm"], rank=training_args.lora_r, alpha=training_args.lora_alpha)}
    params = fp32_masters(params, trainable_filter)
    mesh = _make_mesh(training_args.mesh, device)
    sharded = None
    if mesh is not None:
        check_trainable_on_mesh(params)
        params = shard_params(params, mesh, cfg)
        sharded = Sharded(mesh, cfg, params)
    row_index, row_count = (0, 1) if sharded is None else (sharded.row_rank, sharded.row_count)

    tokens_per_frame = cfg.vision.num_patches + (cfg.mm_vision_select_feature != "patch")
    module = make_supervised_data_module(
        tokenizer, data_args, tokens_per_frame=tokens_per_frame,
        max_length=cfg.tokenizer_model_max_length, dataset=dataset,
    )
    train_dataset, collator = module["train_dataset"], module["data_collator"]
    if training_args.mesh.sequence > 1:
        _check_sequence_buckets(collator, training_args.mesh.sequence)

    accum = max(training_args.gradient_accumulation_steps, 1)
    global_batch = training_args.per_device_train_batch_size * row_count * accum
    steps_per_epoch = max(len(train_dataset) // global_batch, 1)
    total_steps = (
        max_steps_override
        or training_args.max_steps
        or steps_per_epoch * training_args.num_train_epochs
    )
    optimizer = make_optimizer(
        training_args.learning_rate,
        projector_lr=training_args.mm_projector_lr,
        warmup_ratio=training_args.warmup_ratio,
        total_steps=total_steps,
        weight_decay=training_args.weight_decay,
        lr_scheduler_type=training_args.lr_scheduler_type,
        max_grad_norm=training_args.max_grad_norm,
        warmup_steps=training_args.warmup_steps,
    )
    if accum > 1:
        optimizer = MultiSteps(optimizer, accum)

    # auto-resume (reference train.py:1109-1112): the params of the newest
    # checkpoint-*, its optimizer state where it has one (else a fresh one)
    state = init_train_state(params, optimizer, trainable_filter)
    start_step = 0
    resume = latest_checkpoint(training_args.output_dir)
    if resume is not None:
        rank0_print(f"Resuming from {resume}")
        params, _, opt_state = load_checkpoint(
            resume, restore_opt=True, params_template=state.params,
            opt_template=state.opt_state)
        start_step = int(os.path.basename(resume).split("-")[1])
        if opt_state is None:
            opt_state = init_train_state(params, optimizer, trainable_filter).opt_state
        state = TrainState(params, opt_state, start_step)
    del params
    train_step = make_train_step(_run_cfg(cfg, training_args), optimizer,
                                 trainable_filter=trainable_filter,
                                 remat=training_args.gradient_checkpointing, sharded=sharded)
    writer = _writer(training_args) if is_rank0() else None

    sampler = LengthGroupedSampler(
        training_args.per_device_train_batch_size,
        world_size=row_count,
        lengths=train_dataset.modality_lengths,
        generator=np.random.default_rng(training_args.seed),
        group_by_modality=training_args.group_by_modality_length,
    )
    dtype = torch.bfloat16 if training_args.bf16 else torch.float32

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    step, micro = start_step, 0
    tokens = padded = 0
    sync()
    t0 = t_step = time.perf_counter()
    for _ in range(training_args.num_train_epochs):
        batch_stream = _batches(train_dataset, collator, sampler,
                                training_args.per_device_train_batch_size,
                                process_index=row_index, process_count=row_count)
        if training_args.dataloader_num_workers > 0:
            batch_stream = _prefetch(batch_stream, depth=training_args.dataloader_num_workers)
        for plan, pixels in batch_stream:
            if step >= total_steps:
                break
            pixels = torch.as_tensor(pixels).to(device, dtype)
            state, loss = train_step(state, plan, pixels)
            micro += 1
            tokens += int(plan.attention_mask.sum())
            padded += plan.attention_mask.size
            if micro % accum:
                continue  # gradient accumulated; no optimizer update yet
            step += 1
            if history is not None:
                sync()
                now = time.perf_counter()
                history.append({"step": step, "loss": float(loss), "seconds": now - t_step,
                                "tokens": tokens, "padded_tokens": padded})
                t_step, tokens, padded = now, 0, 0
            if step % training_args.logging_steps == 0:
                loss_v = float(loss)
                rank0_print(f"step {step}/{total_steps} loss {loss_v:.4f} "
                            f"({(time.perf_counter() - t0) / training_args.logging_steps:.2f}"
                            f"s/step)", flush=True)
                if writer is not None:
                    writer.add_scalar("train/loss", loss_v, step)
                t0 = time.perf_counter()
            if training_args.save_strategy != "no" and step % training_args.save_steps == 0:
                t_save = time.perf_counter()
                save_checkpoint(training_args.output_dir, state.params, cfg,
                                opt_state=state.opt_state, step=step)
                if is_rank0():
                    _prune_checkpoints(training_args.output_dir, training_args.save_total_limit)
                if sharded is not None:
                    dist.barrier()
                if history is not None:  # the save is not the next step's time
                    t_step = time.perf_counter()
                    history[-1]["save_seconds"] = t_step - t_save
        batch_stream.close()
        if step >= total_steps:
            break

    # final save: params and config, no optimizer state (JAX train.py:531)
    save_checkpoint(training_args.output_dir, state.params, cfg, step=step)
    if writer is not None:
        writer.close()
    return state
