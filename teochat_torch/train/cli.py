"""Train CLI (port of teochat_tpu/train/cli.py): argparse over the dataclass configs.

Accepts the reference's launch flags VERBATIM: the argv of
scripts/train_teochat.sh / finetune_teochat.sh parses unchanged (run
`python -m teochat_torch.train.cli` in place of `python -m
teochat_tpu.train.cli`). `--distributed` starts the process group from
torchrun's environment (JAX's calls `jax.distributed.initialize()`), one
rank a card, and the run trains on the `--mesh_data` / `--mesh_fsdp` /
`--mesh_model` / `--mesh_sequence` (ring attention) / `--mesh_pipe` (GPipe,
`--pipeline_microbatches`) mesh over the ranks (by default every rank on
fsdp, ZeRO-3):
`torchrun --nproc_per_node 8 -m teochat_torch.train.cli --distributed ...`.
`--deepspeed <json>` is accepted and ignored: the mesh replaces ZeRO.
`--device` is the port's own (default: the card; "cpu" runs the
ranks on gloo). A run resumes by itself from the newest `checkpoint-*`
under `--output_dir`.
"""

from __future__ import annotations

import argparse

import torch

from teochat_torch.config import MeshConfig
from teochat_torch.data.dataset import DataArguments
from teochat_torch.parallel.mesh import init_distributed
from teochat_torch.train.train import ModelArguments, TrainingArguments, train
from teochat_torch.utils import profile_trace, rank0_print, resolve_device


def _bool(s: str) -> bool:
    """HfArgumentParser-style boolean: `--flag True` / `--flag False`."""
    if s.lower() in ("true", "1", "yes"):
        return True
    if s.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected True/False, got {s!r}")


def _add_bool(p, name: str, default: bool, **kw) -> None:
    # accepts both bare `--flag` and valued `--flag True/False`
    p.add_argument(name, type=_bool, nargs="?", const=True, default=default, **kw)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="TEOChat fine-tuning on one CUDA card")
    # model (reference train.py:48-64 ModelArguments)
    p.add_argument("--model_name_or_path", type=str, required=True)
    p.add_argument("--version", type=str, default="v1")
    _add_bool(p, "--freeze_backbone", True)
    _add_bool(p, "--tune_mm_mlp_adapter", False)
    _add_bool(p, "--freeze_mm_mlp_adapter", False)
    p.add_argument("--image_tower", type=str, default=None)
    p.add_argument("--video_tower", type=str, default=None)
    p.add_argument("--mm_projector_type", type=str, default="linear")
    p.add_argument("--mm_vision_select_layer", type=int, default=-2)
    p.add_argument("--mm_vision_select_feature", type=str, default="patch")
    p.add_argument("--pretrain_mm_mlp_adapter", type=str, default=None)
    _add_bool(p, "--mm_use_im_start_end", False)
    _add_bool(p, "--mm_use_im_patch_token", True)
    # data (reference train.py:66-77 DataArguments)
    p.add_argument("--data_name", type=str, default="jirvin16/TEOChatlas")
    p.add_argument("--data_split", type=str, default="train")
    p.add_argument("--data_cache_dir", type=str, default=None)
    p.add_argument("--num_frames", type=int, default=8)
    _add_bool(p, "--video_as_image_list", True)
    p.add_argument("--prompt_strategy", type=str, default="interleave")
    _add_bool(p, "--chronological_prefix", True)
    _add_bool(p, "--lazy_preprocess", True)
    p.add_argument("--image_aspect_ratio", type=str, default=None)
    _add_bool(p, "--is_multimodal", True)
    # training (reference train.py:79-120 TrainingArguments + HF surface)
    p.add_argument("--output_dir", type=str, default="./checkpoints/teochat")
    p.add_argument("--num_train_epochs", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--per_device_train_batch_size", type=int, default=4)
    p.add_argument("--per_device_eval_batch_size", type=int, default=1)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--evaluation_strategy", type=str, default="no")
    p.add_argument("--save_strategy", type=str, default="steps")
    p.add_argument("--learning_rate", type=float, default=2e-4)
    p.add_argument("--mm_projector_lr", type=float, default=2e-5)
    p.add_argument("--warmup_ratio", type=float, default=0.03)
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--lr_scheduler_type", type=str, default="cosine")
    p.add_argument("--logging_steps", type=int, default=10)
    p.add_argument("--save_steps", type=int, default=2000)
    p.add_argument("--save_total_limit", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--bits", type=int, default=16, choices=[8, 16])
    _add_bool(p, "--bf16", True)
    _add_bool(p, "--tf32", True, help="accepted for parity; the products are bf16")
    p.add_argument("--model_max_length", type=int, default=None)
    p.add_argument("--tokenizer_model_max_length", type=int, default=None)
    _add_bool(p, "--gradient_checkpointing", True)
    p.add_argument("--dataloader_num_workers", type=int, default=0)
    _add_bool(p, "--lora_enable", True)
    p.add_argument("--no_lora", dest="lora_enable", action="store_false")
    p.add_argument("--lora_r", type=int, default=128)
    p.add_argument("--lora_alpha", type=float, default=256.0)
    p.add_argument("--lora_dropout", type=float, default=0.05)
    p.add_argument("--lora_bias", type=str, default="none")
    p.add_argument("--lora_weight_path", type=str, default="")
    _add_bool(p, "--double_quant", True)
    p.add_argument("--quant_type", type=str, default="nf4")
    p.add_argument("--optim", type=str, default="adamw_torch")
    p.add_argument("--mpt_attn_impl", type=str, default="triton")
    _add_bool(p, "--group_by_modality_length", True)
    p.add_argument("--report_to", type=str, default="tensorboard")
    p.add_argument("--cache_dir", type=str, default=None)
    p.add_argument("--deepspeed", type=str, default=None,
                   help="accepted and ignored: the mesh (--mesh_* flags) replaces ZeRO")
    _add_bool(p, "--remove_unused_columns", False)
    # the mesh over the --distributed ranks (the JAX driver's knobs)
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--mesh_fsdp", type=int, default=-1)
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--mesh_sequence", type=int, default=1,
                   help="context parallelism: shard the sequence over this "
                        "many devices (ring attention)")
    p.add_argument("--mesh_pipe", type=int, default=1,
                   help="pipeline parallelism: shard the layer stack over "
                        "this many stages (GPipe microbatch schedule)")
    p.add_argument("--pipeline_microbatches", type=int, default=None,
                   help="microbatches per pipeline step (default: stage "
                        "count); batch size must divide evenly")
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--distributed", action="store_true",
                   help="multi-process training: init torch.distributed from torchrun's "
                        "environment (RANK, WORLD_SIZE, MASTER_ADDR/PORT, LOCAL_RANK)")
    p.add_argument("--device", type=str, default=None,
                   help="where the model loads and trains (default: the card)")
    return p


def parse_args(argv=None):
    """(ModelArguments, DataArguments, TrainingArguments, the namespace) of `argv`."""
    args = build_parser().parse_args(argv)

    model_args = ModelArguments(
        model_name_or_path=args.model_name_or_path,
        version=args.version,
        freeze_backbone=args.freeze_backbone,
        tune_mm_mlp_adapter=args.tune_mm_mlp_adapter,
        freeze_mm_mlp_adapter=args.freeze_mm_mlp_adapter,
        image_tower=args.image_tower,
        video_tower=args.video_tower,
        mm_projector_type=args.mm_projector_type,
        mm_vision_select_layer=args.mm_vision_select_layer,
        mm_vision_select_feature=args.mm_vision_select_feature,
        pretrain_mm_mlp_adapter=args.pretrain_mm_mlp_adapter,
        mm_use_im_start_end=args.mm_use_im_start_end,
        mm_use_im_patch_token=args.mm_use_im_patch_token,
    )
    data_args = DataArguments(
        data_name=args.data_name,
        data_split=args.data_split,
        data_cache_dir=args.data_cache_dir,
        lazy_preprocess=args.lazy_preprocess,
        is_multimodal=args.is_multimodal,
        num_frames=args.num_frames,
        video_as_image_list=args.video_as_image_list,
        prompt_strategy=args.prompt_strategy,
        chronological_prefix=args.chronological_prefix,
        image_aspect_ratio=args.image_aspect_ratio,
    )
    training_args = TrainingArguments(
        output_dir=args.output_dir,
        num_train_epochs=args.num_train_epochs,
        max_steps=args.max_steps,
        per_device_train_batch_size=args.per_device_train_batch_size,
        per_device_eval_batch_size=args.per_device_eval_batch_size,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        evaluation_strategy=args.evaluation_strategy,
        save_strategy=args.save_strategy,
        learning_rate=args.learning_rate,
        mm_projector_lr=args.mm_projector_lr,
        warmup_ratio=args.warmup_ratio,
        warmup_steps=args.warmup_steps,
        max_grad_norm=args.max_grad_norm,
        weight_decay=args.weight_decay,
        lr_scheduler_type=args.lr_scheduler_type,
        logging_steps=args.logging_steps,
        save_steps=args.save_steps,
        save_total_limit=args.save_total_limit,
        seed=args.seed,
        bits=args.bits,
        bf16=args.bf16,
        tf32=args.tf32,
        model_max_length=args.model_max_length,
        tokenizer_model_max_length=args.tokenizer_model_max_length,
        gradient_checkpointing=args.gradient_checkpointing,
        dataloader_num_workers=args.dataloader_num_workers,
        lora_enable=args.lora_enable,
        lora_r=args.lora_r,
        lora_alpha=args.lora_alpha,
        lora_dropout=args.lora_dropout,
        lora_bias=args.lora_bias,
        lora_weight_path=args.lora_weight_path,
        double_quant=args.double_quant,
        quant_type=args.quant_type,
        optim=args.optim,
        mpt_attn_impl=args.mpt_attn_impl,
        group_by_modality_length=args.group_by_modality_length,
        report_to=args.report_to,
        cache_dir=args.cache_dir,
        mesh=MeshConfig(data=args.mesh_data, fsdp=args.mesh_fsdp,
                        model=args.mesh_model, sequence=args.mesh_sequence,
                        pipe=args.mesh_pipe),
        pipeline_microbatches=args.pipeline_microbatches,
    )
    return model_args, data_args, training_args, args


def main(argv=None, history=None):
    """Parse `argv` (sys.argv without one) and train; returns the final
    state. `history` is passed to `train`."""
    model_args, data_args, training_args, args = parse_args(argv)
    if args.distributed:
        device = resolve_device(args.device)
        init_distributed(device.type)
    if args.deepspeed:
        rank0_print(f"--deepspeed {args.deepspeed} ignored: the mesh (--mesh_data / "
                    f"--mesh_fsdp / --mesh_model over --distributed ranks) replaces ZeRO")
    if args.evaluation_strategy != "no":
        rank0_print(
            f"--evaluation_strategy {args.evaluation_strategy} not supported "
            f"in-loop; run teochat_torch.eval.eval on saved checkpoints"
        )
    try:
        with profile_trace(args.profile_dir):
            return train(model_args, data_args, training_args, history=history,
                         device=args.device)
    finally:
        if args.distributed:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
