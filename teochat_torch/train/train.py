"""Train driver (port of teochat_tpu/train/train.py::train).

The TEOChat fine-tuning recipe on one CUDA device (or the CPU): LoRA
r=128 / alpha=256 on every decoder projection over a frozen (optionally
int8) backbone, the projector trained in its own learning-rate group, the
tower frozen, AdamW + warmup + cosine, gradient accumulation, decoder-layer
remat, and modality-grouped batching. `ModelArguments` and
`TrainingArguments` copy the fields this path reads from the JAX module
(which imports jax); the rest of the JAX surface is not ported yet: the
builder (params, cfg and tokenizer must be passed in), training without
LoRA, the device mesh, sequence and pipeline axes, resume, checkpoint
saving (`save_strategy` must be "no"), the vision tokenizer, tensorboard
and wandb writers and the prefetch thread.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from teochat_torch.config import TEOChatConfig
from teochat_torch.data.sampler import LengthGroupedSampler
from teochat_torch.data.dataset import (
    DataArguments,
    make_supervised_data_module,
    set_default_conversation,
)
from teochat_torch.train.lora import add_lora_params, lora_trainable_filter
from teochat_torch.train.trainer import (
    MultiSteps,
    TrainState,
    fp32_masters,
    init_train_state,
    make_optimizer,
    make_train_step,
)


@dataclass
class ModelArguments:
    """The fields of the reference ModelArguments (train.py:48-72) this path reads."""

    version: str = "v1"
    mm_use_im_start_end: bool = False


@dataclass
class TrainingArguments:
    """The fields of the JAX TrainingArguments this path reads, same defaults
    except `save_strategy` (saving is not ported yet). LoRA is always on:
    training without it (projector only, or the full backbone) is not
    ported yet."""

    num_train_epochs: int = 1
    max_steps: Optional[int] = None
    per_device_train_batch_size: int = 4
    gradient_accumulation_steps: int = 1
    learning_rate: float = 2e-4
    mm_projector_lr: Optional[float] = 2e-5
    warmup_ratio: float = 0.03
    weight_decay: float = 0.0
    logging_steps: int = 10
    seed: int = 42
    bf16: bool = True
    lora_r: int = 128
    lora_alpha: float = 256.0
    group_by_modality_length: bool = True
    gradient_checkpointing: bool = True
    lr_scheduler_type: str = "cosine"
    max_grad_norm: float = 1.0
    warmup_steps: int = 0
    model_max_length: Optional[int] = None
    tokenizer_model_max_length: Optional[int] = None
    save_strategy: str = "no"


def _batches(dataset, collator, sampler: Iterable[int], batch_size: int):
    """Consecutive sampler chunks of `batch_size` indices, collated (one
    process: every chunk is this process's)."""
    buf: List[int] = []
    for idx in sampler:
        buf.append(idx)
        if len(buf) == batch_size:
            yield collator([dataset[i] for i in buf])
            buf = []


def train(
    model_args: ModelArguments,
    data_args: DataArguments,
    training_args: TrainingArguments,
    *,
    cfg: TEOChatConfig,
    params: Dict,
    tokenizer,
    dataset=None,
    max_steps_override: Optional[int] = None,
    history: Optional[List[Dict]] = None,
) -> TrainState:
    """Run fine-tuning on the device that holds `params`; returns the final
    state. `history`, when given, receives one dict per optimizer step: the
    step, its last micro-batch's loss, its wall seconds (synchronised) and
    its valid and padded token counts."""
    if training_args.save_strategy != "no":
        raise NotImplementedError("checkpoint saving is not ported yet: use save_strategy='no'")
    if model_args.mm_use_im_start_end:
        raise NotImplementedError("mm_use_im_start_end (the vision tokenizer) is not ported yet")
    np.random.seed(training_args.seed)
    set_default_conversation(model_args.version)
    device = params["llm"]["embed_tokens"]["embedding"].device

    if training_args.model_max_length or training_args.tokenizer_model_max_length:
        cfg = dataclasses.replace(
            cfg,
            max_sequence_length=training_args.model_max_length or cfg.max_sequence_length,
            tokenizer_model_max_length=training_args.tokenizer_model_max_length
            or cfg.tokenizer_model_max_length,
        )
    data_args.mm_use_im_start_end = model_args.mm_use_im_start_end

    # LoRA on the frozen backbone, the projector trained, the tower frozen
    # (reference train.py:974-1006); the trainable leaves train as fp32 masters
    gen = torch.Generator(device=device).manual_seed(training_args.seed)
    params = fp32_masters({**params, "llm": add_lora_params(
        gen, params["llm"], rank=training_args.lora_r, alpha=training_args.lora_alpha)},
        lora_trainable_filter)

    tokens_per_frame = cfg.vision.num_patches + (cfg.mm_vision_select_feature != "patch")
    module = make_supervised_data_module(
        tokenizer, data_args, tokens_per_frame=tokens_per_frame,
        max_length=cfg.tokenizer_model_max_length, dataset=dataset,
    )
    train_dataset, collator = module["train_dataset"], module["data_collator"]

    accum = max(training_args.gradient_accumulation_steps, 1)
    global_batch = training_args.per_device_train_batch_size * accum
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
    state = init_train_state(params, optimizer, lora_trainable_filter)
    train_step = make_train_step(cfg, optimizer, trainable_filter=lora_trainable_filter,
                                 remat=training_args.gradient_checkpointing)

    sampler = LengthGroupedSampler(
        training_args.per_device_train_batch_size,
        world_size=1,
        lengths=train_dataset.modality_lengths,
        generator=np.random.default_rng(training_args.seed),
        group_by_modality=training_args.group_by_modality_length,
    )
    dtype = torch.bfloat16 if training_args.bf16 else torch.float32

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    step, micro = 0, 0
    tokens = padded = 0
    sync()
    t0 = t_step = time.perf_counter()
    for _ in range(training_args.num_train_epochs):
        for plan, pixels in _batches(train_dataset, collator, sampler,
                                     training_args.per_device_train_batch_size):
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
                print(f"step {step}/{total_steps} loss {float(loss):.4f} "
                      f"({(time.perf_counter() - t0) / training_args.logging_steps:.2f}s/step)",
                      flush=True)
                t0 = time.perf_counter()
        if step >= total_steps:
            break
    return state
