"""Measurements of the PyTorch / CUDA port on one NVIDIA card, beside the smoke.

    python3 chip_probe.py decode [--root DIR] [--quant int8 int4] [--batches 1 8]
    python3 chip_probe.py decode-paths [--turns 3]
    python3 chip_probe.py parity [--seeds 0 1] [--layers 32 4] [--pairs auto:plain ...]
    python3 chip_probe.py k1
    python3 chip_probe.py k4
    python3 chip_probe.py k1k4a [--root DIR] [--tiles 64x64 128x128 ...] [--long]
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
- k1: the smoke's K1 phase (the flash forward against its plain twin at the
  prefill shapes, head_dim 64, short, strided and non-causal cases); exits
  nonzero where it fails.
- k4: the smoke's K4 phase (the kernels against their plain twin at the
  training shapes); exits nonzero where it fails.
- k1k4a: the flash forward alone at the table's two shapes (K1: B1 S768, K4a
  with its statistics: B4 S1024; H32 D128, causal): the tree's kernel as
  its wrappers launch it, `scaled_dot_product_attention` on the same
  inputs, and, where the tree's source has the tile macros, the same source
  built for each query-tile x kv-tile size of --tiles (`BQxBK`, or
  `BQxBKxSTAGES` for another depth of the kv ring; each held to the tree's
  own output). With `--root` on a parent checkout (say, unpacked with
  `git archive` into the gitignored `results/`) and once without, both
  kernels are read in one run on one card.
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


# ------------------------------------------------------------------ k1k4a

K1K4A_SHAPES = (("K1", 1, 768, False), ("K4a", 4, 1024, True))  # (row, B, S, with m and l)


def _flash_tile_builds(build, tiles):
    """flash_attention.cu compiled once for each (BQ, BK, stages), all at once;
    returns {(bq, bk, stages): ctypes library}."""
    import ctypes
    import subprocess

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for bq, bk, stages in tiles:
        out = build.BUILD_DIR / f"flash_probe_bq{bq}_bk{bk}_st{stages}.so"
        procs[bq, bk, stages] = (out, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, f"-DTEOCHAT_FLASH_BQ={bq}",
             f"-DTEOCHAT_FLASH_BK={bk}", f"-DTEOCHAT_FLASH_STAGES={stages}", "-shared", "-o", str(out),
             str(build.CSRC / "flash_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tile, (out, proc) in procs.items():
        log = proc.communicate()[0]
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "arning", "rror")):
                print(f"[k1k4a] build {tile}: {line.strip()}", flush=True)
        if proc.returncode != 0:
            sys.exit(f"[k1k4a] nvcc failed for tile {tile}")
        libs[tile] = ctypes.CDLL(str(out))
        for name in ("teochat_flash_attention_fwd", "teochat_flash_attention_fwd_res"):
            fn = getattr(libs[tile], name)
            fn.argtypes, fn.restype = build._SIGNATURES[name], ctypes.c_int
    return libs


SASS_OPCODES = ("HGMMA", "UTMALDG", "HMMA", "LDS", "STS", "LDG", "STG", "SYNCS", "MUFU", "SHFL",
                "BAR", "WARPGROUP")


def _flash_forward_sass(build):
    """Static opcode counts of each forward kernel in the tree's built
    library, by `cuobjdump -sass`: what the two products and the loads
    compiled to."""
    import re
    import shutil
    import subprocess
    from collections import Counter

    tool = shutil.which("cuobjdump") or str(Path(build._nvcc()).with_name("cuobjdump"))
    text = subprocess.run([tool, "-sass", str(build.library().path)], capture_output=True,
                          text=True, check=True).stdout
    for block in text.split("Function : ")[1:]:
        name = block.split(None, 1)[0]
        if "flash_fwd_kernel" not in name:
            continue
        ops = Counter(re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?([A-Z][A-Z0-9_]*)", block))
        counts = ", ".join(f"{op} {ops.get(op, 0)}" for op in SASS_OPCODES)
        print(f"[k1k4a] sass {name}: {sum(ops.values())} instructions: {counts}", flush=True)


def cmd_k1k4a(smoke, args):
    import torch.nn.functional as F

    from teochat_torch.ops import _build as build
    from teochat_torch.ops import flash_attention as flash_mod

    _flash_forward_sass(build)
    source = (build.CSRC / "flash_attention.cu").read_text()
    tiles = [tuple(int(x) for x in (t + "x2").split("x")[:3]) for t in args.tiles]
    libs = _flash_tile_builds(build, tiles) if "TEOCHAT_FLASH_BQ" in source else {}
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    h, d = 32, 128
    scale = d ** -0.5
    shapes = K1K4A_SHAPES + ((("S4096", 1, 4096, False),) if args.long else ())
    for row, b, s, stats in shapes:
        q, k, v = (smoke._randn((b, s, h, d), gen) for _ in range(3))
        flops = 4 * b * h * s * s * d / 2
        if stats:
            own = lambda: flash_mod._fwd_res_cuda(q, k, v, True, scale)[0]  # noqa: E731
        else:
            own = lambda: flash_mod._flash_cuda(q, k, v, True, scale)  # noqa: E731
        ref = own()
        want = flash_mod.flash_attention_plain(q.float(), k.float(), v.float(), causal=True)
        err = (ref.float() - want).abs().max().item()
        lib_ms = smoke.time_ms(lambda: F.scaled_dot_product_attention(
            smoke._bhsd(q), smoke._bhsd(k), smoke._bhsd(v), is_causal=True))
        ms = smoke.time_ms(own)
        print(f"[k1k4a] root={args.root} {row} B={b} S={s} H={h} D={d}: kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), max_abs_err {err:.3e}; "
              f"scaled_dot_product_attention {lib_ms:.4f} ms ({ms / lib_ms:.2f}x)", flush=True)
        out = torch.empty_like(ref)
        m = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
        l = torch.empty_like(m)
        for (bq, bk, stages), lib in libs.items():
            stream = torch.cuda.current_stream().cuda_stream
            tail = (b, s, s, h, h, d, *flash_mod._strides(q, k, v), scale, 1, stream)
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
            if stats:
                run = lambda: lib.teochat_flash_attention_fwd_res(  # noqa: E731
                    *ptrs, m.data_ptr(), l.data_ptr(), *tail)
            else:
                run = lambda: lib.teochat_flash_attention_fwd(*ptrs, *tail)  # noqa: E731
            out.zero_()
            rc = run()
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs().max().item()
            t_ms = smoke.time_ms(run)
            print(f"[k1k4a]   tile BQ={bq} BK={bk} stages={stages}: {t_ms:.4f} ms ({flops / t_ms / 1e9:.1f} "
                  f"TFLOP/s, {t_ms / lib_ms:.2f}x the library call), rc {rc}, max |o - tree's o| "
                  f"{diff:.3e}", flush=True)


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


def cmd_k1(smoke, args):
    _run_phases(smoke, (("k1", smoke.phase_flash),))


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
    for name in ("decode", "decode-paths", "parity", "k1", "k4", "k1k4a", "k3k5", "s1s2",
                 "profile-train"):
        p = sub.add_parser(name)
        p.add_argument("--root", type=Path, default=Path(__file__).parent)
        if name == "decode":
            p.add_argument("--reps", type=int, default=5)
            p.add_argument("--quant", nargs="+", default=["int8"], choices=["int8", "int4"])
            p.add_argument("--batches", type=int, nargs="+", default=[1, 8])
        if name == "k1k4a":
            p.add_argument("--tiles", nargs="+", default=["64x64", "64x128", "128x64", "128x128"])
            p.add_argument("--long", action="store_true",
                           help="also B1 S4096: many kv tiles a block, little set-up beside them")
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
    {"decode": cmd_decode, "decode-paths": cmd_decode_paths, "parity": cmd_parity, "k1": cmd_k1,
     "k4": cmd_k4, "k1k4a": cmd_k1k4a, "k3k5": cmd_k3k5, "s1s2": cmd_s1s2, "profile-train": cmd_profile_train}[args.cmd](smoke, args)


if __name__ == "__main__":
    main()
