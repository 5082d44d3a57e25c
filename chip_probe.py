"""Measurements of the PyTorch / CUDA port on one NVIDIA card, beside the smoke.

    python3 chip_probe.py decode [--root DIR] [--quant int8 int4] [--batches 1 8]
    python3 chip_probe.py decode-paths [--turns 3]
    python3 chip_probe.py parity [--seeds 0 1] [--layers 32 4] [--pairs auto:plain ...]
    python3 chip_probe.py k4
    python3 chip_probe.py k3k5
    python3 chip_probe.py s1s2
    python3 chip_probe.py profile-train

Each command prints the card's name and power limit first, then its lines.
`--root` (every command) imports `teochat_torch` and `chip_smoke` from
another checkout, so two trees can be timed in one session on one card.

- decode: the main bench's decode set-up (`teochat_torch.bench.main`: the
  2-frame prompt of 640 fused tokens on stand-in embeddings, a random
  LLaMA-7B decoder from seed 0, greedy, never stopping) at each batch size
  of --batches, for each weight format of --quant in turn (int4 is the
  fused packed decoder with its int4 lm_head): prefill + first token and ms
  per decode step, from the median wall time of `generate_tokens` with 1
  and with 33 new tokens over --reps runs. One process, one card: int8 and
  int4 are read side by side. `--root` needs a tree that has the bench.
- decode-paths: one int8 model, one process: ms per decode step of the
  smoke's 2-frame request through `TEOChat.generate` and of the bench's
  decode set-up, in turns, so that the two can be told from the host's
  spread.
- parity: one 7B-width training micro-step (the smoke's parity batch) under
  each attention of a pair, for each seed and decoder depth: the loss
  difference and the gradients' relative L2, overall and for the worst
  leaf. Attentions: `auto` (the K4 kernels), `plain` (the fp32 reference,
  which rounds P to bf16 before PV as the kernels do) and `plain_fp32`
  (the same on fp32 q, k and v: P and dP unrounded).
- k4: the smoke's K4 phase (the kernels against their plain twin at the
  training shapes); exits nonzero where it fails.
- k3k5: the smoke's K3 and K5 phases (the int4 products and the ViT attention
  against their plain versions at the 7B shapes); exits nonzero where one
  fails, after running both.
- s1s2: the smoke's phases for the kernel benches' eight variants (the int4
  ones and the one-sweep attention ones against their plain versions); exits
  nonzero where one fails, after running both.
- profile-train: `torch.profiler` over the second optimizer step of the
  smoke's `train()` run (two micro-steps); device time by kernel class and
  the kernels that take the most.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import statistics
import sys
from collections import defaultdict
from pathlib import Path

import torch


def _import_tree(root: Path):
    """The smoke module of `root`, with `root` first on the import path."""
    sys.path.insert(0, str(root.resolve()))
    return importlib.import_module("chip_smoke")


# ------------------------------------------------------------------ decode


def cmd_decode(smoke, args):
    from teochat_torch.bench import main as bench_main

    n_new = 33
    settings = bench_main.Settings(seed=smoke.SEED, decode_new=n_new)
    for quant in args.quant:
        for bs in args.batches:
            with torch.no_grad():
                run_generate, _, prompt_len = bench_main.build_decode_setup(settings, bs, quant)
                run_generate(1)
                run_generate(n_new)  # warm-up
                t1, tn = [], []
                for _ in range(args.reps):
                    t1.append(smoke.wall(lambda: run_generate(1))[1])
                    tn.append(smoke.wall(lambda: run_generate(n_new))[1])
            steps = n_new - 1
            ttft, full = statistics.median(t1), statistics.median(tn)
            ms_step = (full - ttft) / steps * 1e3
            print(f"[decode] root={args.root} {quant} bs {bs}: prefill of {prompt_len} tokens + "
                  f"first token {ttft * 1e3:.2f} ms (median of {args.reps}, "
                  f"{min(t1) * 1e3:.2f}-{max(t1) * 1e3:.2f}); {steps} decode steps "
                  f"{ms_step:.3f} ms/step, {bs * 1e3 / ms_step:.2f} tok/s (generate of "
                  f"{n_new} tokens: median {full * 1e3:.2f} ms, {min(tn) * 1e3:.2f}-"
                  f"{max(tn) * 1e3:.2f})", flush=True)
            del run_generate
            torch.cuda.empty_cache()


def cmd_decode_paths(smoke, args):
    from teochat_torch.bench import main as bench_main
    from teochat_torch.config import GenerationConfig, TEOChatConfig
    from teochat_torch.constants import IMAGE_TOKEN_INDEX
    from teochat_torch.mm_utils import tokenizer_image_token

    n_new = 33
    with torch.no_grad():
        run_generate, _, _ = bench_main.build_decode_setup(
            bench_main.Settings(seed=smoke.SEED, decode_new=n_new), 1, "int8")
    cfg = TEOChatConfig(quant="int8")
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    tokenizer = smoke.WordTokenizer()
    model = smoke.teochat_mod.TEOChat(
        cfg, smoke.init_teochat(cfg, gen, "cuda", torch.bfloat16, quant="int8"),
        tokenizer=tokenizer)
    frames = smoke.FrameProcessor(cfg.vision.image_size, smoke.SEED).preprocess(
        ["a", "b"])["pixel_values"]
    ids = tokenizer_image_token(
        smoke.PROMPT_2.replace("<video>", "Image 1: <image> Image 2: <image>"), tokenizer,
        IMAGE_TOKEN_INDEX)
    g1, gn = (GenerationConfig(max_new_tokens=n, temperature=0.0, do_sample=False,
                               stop_strings=()) for n in (1, n_new))
    for turn in range(args.turns + 1):  # turn 0 warms both up
        s1 = smoke.wall(lambda: model.generate([ids], frames, g1))[1]
        sn = smoke.wall(lambda: model.generate([ids], frames, gn))[1]
        with torch.no_grad():
            b1 = smoke.wall(lambda: run_generate(1))[1]
            bn = smoke.wall(lambda: run_generate(n_new))[1]
        if turn:
            print(f"[decode-paths] turn {turn}: generate {(sn - s1) / (n_new - 1) * 1e3:.2f} "
                  f"ms/step (TTFT {s1 * 1e3:.2f} ms); bench set-up "
                  f"{(bn - b1) / (n_new - 1) * 1e3:.2f} ms/step (prefill + 1 token "
                  f"{b1 * 1e3:.2f} ms)", flush=True)


# ------------------------------------------------------------------ parity


@contextlib.contextmanager
def _attention(name: str):
    """attn_impl for forward_train, with `plain_fp32` patched in for the block."""
    if name != "plain_fp32":
        yield name
        return
    from teochat_torch.ops import attention as attn_mod

    plain = attn_mod.plain_attention

    def fp32(q, k, v, **kw):
        return plain(q.float(), k.float(), v.float(), **kw).to(q.dtype)

    attn_mod.plain_attention = fp32
    try:
        yield "plain"
    finally:
        attn_mod.plain_attention = plain


def cmd_parity(smoke, args):
    from teochat_torch.config import TEOChatConfig

    names = sorted({n for pair in args.pairs for n in pair.split(":")})
    for layers in args.layers:
        base = TEOChatConfig(quant="int8")
        cfg = dataclasses.replace(base, llm=dataclasses.replace(base.llm, num_layers=layers))
        for seed in args.seeds:
            gen = torch.Generator(device="cuda").manual_seed(seed)
            params = smoke.init_teochat(cfg, gen, "cuda", torch.bfloat16, quant="int8")
            processor = smoke.FrameProcessor(cfg.vision.image_size, seed)
            params, leaves, plan, pixels = smoke.parity_batch(
                cfg, params, smoke.WordTokenizer(), processor, gen)
            steps = {}
            for name in names:
                with _attention(name) as impl:
                    steps[name] = smoke.micro_step(cfg, params, leaves, plan, pixels, impl)
            for pair in args.pairs:
                a, b = pair.split(":")
                loss_rel, total, rels = smoke.compare_steps(leaves, steps[a], steps[b])
                worst = max(rels, key=rels.get)
                print(f"[parity] layers {layers} seed {seed} {a} vs {b}: loss "
                      f"{steps[a][0]:.6f} vs {steps[b][0]:.6f} rel {loss_rel:.3e}; gradients "
                      f"rel L2 {total:.3e} over {len(rels)} leaves, worst {worst} "
                      f"{rels[worst]:.3e}", flush=True)
            del params, leaves, steps
            torch.cuda.empty_cache()


# ------------------------------------------------------------------ k4


def cmd_k4(smoke, args):
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    try:
        smoke.phase_flash_backward(gen)
    except RuntimeError as e:
        print(f"[k4] FAILED: {e}", flush=True)
        sys.exit(1)
    print("[k4] passed", flush=True)


def _run_phases(smoke, phases):
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    failed = False
    for name, phase in phases:
        try:
            phase(gen)
            print(f"[{name}] passed", flush=True)
        except RuntimeError as e:
            failed = True
            print(f"[{name}] FAILED: {e}", flush=True)
    sys.exit(1 if failed else 0)


def cmd_k3k5(smoke, args):
    _run_phases(smoke, (("k5", smoke.phase_vit_attention), ("k3", smoke.phase_int4)))


def cmd_s1s2(smoke, args):
    _run_phases(smoke, (("s2", smoke.phase_bench_vit), ("s1", smoke.phase_bench_int4)))


# ------------------------------------------------------------------ profile-train


KERNEL_CLASSES = (  # (class, substrings of the kernel's name); the first match wins
    ("K4b dK/dV", ("flash_bwd_dkv",)),
    ("K4c dQ", ("flash_bwd_dq",)),
    ("K4a forward", ("flash_fwd",)),
    ("GEMM", ("nvjet", "gemm", "xmma", "cutlass")),
    ("copies and dtype converts", ("copy",)),
    ("reductions", ("reduce",)),
    ("softmax", ("softmax",)),
    ("elementwise", ("elementwise", "vectorized")),
)


def cmd_profile_train(smoke, args):
    from torch.profiler import ProfilerActivity, profile

    from teochat_torch.config import TEOChatConfig
    from teochat_torch.train import train as train_mod

    cfg = TEOChatConfig(quant="int8")
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    params = smoke.init_teochat(cfg, gen, "cuda", torch.bfloat16, quant="int8")
    processor = smoke.FrameProcessor(cfg.vision.image_size, smoke.SEED)
    # micro-steps 1-2 are the first optimizer step, 3-4 the second (recorded)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    make_step = train_mod.make_train_step
    micro = [0]

    def profiled_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, plan, pixels):
            micro[0] += 1
            if micro[0] == 3:
                torch.cuda.synchronize()
                prof.start()
            out = step(state, plan, pixels)
            if micro[0] == 4:
                torch.cuda.synchronize()
                prof.stop()
            return out

        return run

    train_mod.make_train_step = profiled_step
    targs = train_mod.TrainingArguments(
        per_device_train_batch_size=4, gradient_accumulation_steps=2, learning_rate=2e-4,
        mm_projector_lr=2e-5, lr_scheduler_type="cosine", warmup_ratio=0.03, max_grad_norm=1.0,
        gradient_checkpointing=True, max_steps=3, num_train_epochs=2, save_strategy="no",
        logging_steps=1, lora_r=128, lora_alpha=256.0, bf16=True, seed=smoke.SEED)
    history = []
    train_mod.train(train_mod.ModelArguments(),
                    smoke.DataArguments(image_processor=processor), targs, cfg=cfg,
                    params=params, tokenizer=smoke.WordTokenizer(),
                    dataset=smoke.train_samples(smoke.N_TRAIN_SAMPLES), history=history)
    for h in history:
        print(f"[profile] step {h['step']}: {h['seconds']:.4f} s wall (profiler on for step 2)")
    by_name = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
            by_name[e.name][1] += 1
    total = sum(ms for ms, _ in by_name.values())
    if not total:
        sys.exit("[profile] the profiler recorded no device kernels")
    by_class = defaultdict(lambda: [0.0, 0])
    for name, (ms, n) in by_name.items():
        label = next((c for c, keys in KERNEL_CLASSES if any(k in name for k in keys)), "other")
        by_class[label][0] += ms
        by_class[label][1] += n
    print(f"[profile] optimizer step 2 (2 micro-steps): {total:.2f} ms of device kernel time")
    for label, (ms, n) in sorted(by_class.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile] {label}: {ms:.2f} ms ({100 * ms / total:.1f} %), {n} launches")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"[profile]   {ms:9.2f} ms {n:6d}x {name[:150]}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in ("decode", "decode-paths", "parity", "k4", "k3k5", "s1s2", "profile-train"):
        p = sub.add_parser(name)
        p.add_argument("--root", type=Path, default=Path(__file__).parent)
        if name == "decode":
            p.add_argument("--reps", type=int, default=5)
            p.add_argument("--quant", nargs="+", default=["int8"], choices=["int8", "int4"])
            p.add_argument("--batches", type=int, nargs="+", default=[1, 8])
        if name == "decode-paths":
            p.add_argument("--turns", type=int, default=3)
        if name == "parity":
            p.add_argument("--seeds", type=int, nargs="+", default=[0])
            p.add_argument("--layers", type=int, nargs="+", default=[32])
            p.add_argument("--pairs", nargs="+", default=["auto:plain"])
    args = parser.parse_args()
    smoke = _import_tree(args.root)
    smoke.phase_device()
    smoke.phase_build()
    {"decode": cmd_decode, "decode-paths": cmd_decode_paths, "parity": cmd_parity, "k4": cmd_k4,
     "k3k5": cmd_k3k5, "s1s2": cmd_s1s2, "profile-train": cmd_profile_train}[args.cmd](smoke, args)


if __name__ == "__main__":
    main()
