"""Smoke run of the PyTorch / CUDA port (teochat_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; fails (nonzero exit, no result line) without
them. Phases, each printing its lines before the last:

1. device: the card's name and power limit, as nvidia-smi reports them;
2. build: compile the CUDA kernels from teochat_torch/csrc (seconds, and
   ptxas's register / spill report);
3. the flash-attention kernel (K1) against its plain twin at prefill shapes,
   at head_dim 64, below 64 rows, on strided slices of a fused q|k|v
   projection and on a non-causal call with S != T;
4. the decode-attention kernel (K2) against its plain twin at decode shapes,
   at the edges of its slot chunks (1, CHUNK - 1, CHUNK, CHUNK + 1 and T
   live slots), in a ragged batch and with rows of no live slot (written as
   0); each case twice, bit-equal;
5. the int4 products (K3a flat, K3b tiled, K3c tiled and layer-stacked)
   against their plain version at the 7B projections' shapes, M = 1, 4 (the
   split-K `mma.sync` decode kernel), 16 and 768 (the M > 8 `wgmma`
   kernel), each beside `torch._weight_int4pack_mm` on the same weights;
6. the one-shot ViT attention (K5) against its plain version at the tower's
   shape for a 2-frame request and a 32-frame encode, at a ragged 100, at a
   336-pixel tower's 577 and at the gate's 1024;
7. the int4 path at TEOChat-7B width and depth (ViT-L/14 through K5,
   mlp2x_gelu, LLaMA-7B with fused packed-int4 projections and an int4
   lm_head, bf16 activations, random weights from a seed): three requests
   through `run_inference_single` and one batched generate of four ragged
   rows; the launch counts of K1, K2, K3b, K3c and K5 must rise;
8. the prefill logits of that model with the int4 kernels against the same
   forward on the plain `int4_proj`;
9. one request through a 4-layer decoder at 7B width with 2 kv heads and
   unfused int4 projections, whose k and v are flat leaves: K3a must launch;
10. the int8 path at TEOChat-7B width (LLaMA-7B with int8 weights): the same
    requests; K1, K2 and K5 must launch;
11. the last-position prefill logits of the 2-frame request with the kernels
    against the same forward on the plain attention;
12. the training flash attention (K4a forward, the di preamble, K4b dK/dV,
    K4c dQ) against autograd through its plain twin at training shapes, at
    head_dim 64, on non-causal calls with S != T, on ragged lengths that
    leave the last tiles part-filled and on strided slices of a fused q|k|v;
    K4a's m and l against the plain row maximum and sum; di against its
    torch line; K4b and K4c from saved residuals against their tile walks
    (`flash_backward_dkv_schedule`, `_dq_schedule`) on the same bf16 inputs;
    and each kernel's time beside the plain forward's and backward's and the
    library's one backward call;
13. the training path at TEOChat-7B width: the port's `train()` takes three
    optimizer steps (int8 backbone, LoRA r128 on all seven projections, fp32
    projector, cosine schedule, accumulation 2, remat) on 16 synthetic
    2-frame conversations; the three K4 launch counts must rise;
14. one micro-step's loss and trainable gradients with the kernels against
    the same step on the plain attention;
15. the kernel benches' eight variants (teochat_torch/bench/int4_kernel.py:
    v2, v3, v4, v5, vpu, dma; bench/vit_attention.py: b, c) against their
    plain versions: the int4 ones at K 4096, N 11008, M = 1 and 8, tiles of
    512, with `torch._weight_int4pack_mm` on the same weights beside v4 at
    M 1 and beside v2 and v5 at M 1 and 8; the attention ones at
    [32, 257, 16, 64] and [2, 257, 16, 64], at S 9 and 100, and at S 300
    and 832 (two sweeps);
16. the two kernel benches in-process (`int4_kernel.main(quick=True)`,
    `vit_attention.main()`): the eight launch counts, and those of K3b and
    K5 (their `v0` and `current` rows), must rise;
17. the main bench (`teochat_torch.bench.main`) with `--phases encode e2e`.

Every path runs at full width and depth. Beside each kernel's time the run
takes the time of its plain version, of the one PyTorch call that computes
the same function where there is one (`scaled_dot_product_attention`,
`torch._weight_int4pack_mm`; used nowhere in the port), and works out the
least time the card could take:
the larger of the bytes moved over 3.35 TB/s and the operations over
989 TFLOP/s (bf16), the H100 SXM's published rates.

The line before the last is a JSON object with each of the eighteen
kernel rows' launches, error, times and bound (K3c has two: its wrapper runs
the M > 8 kernel at prefill and the split-K one at decode); the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import statistics
import sys
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

from teochat_torch.bench import _timing
from teochat_torch.bench import int4_kernel as bench_int4
from teochat_torch.bench import main as bench_main
from teochat_torch.bench import vit_attention as bench_vit
from teochat_torch.bench._timing import bound_ms, kernel_row, sync, time_ms, wall
from teochat_torch.config import GenerationConfig, TEOChatConfig
from teochat_torch.constants import IMAGE_TOKEN_INDEX, OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
from teochat_torch.eval.inference import run_inference_single
from teochat_torch.mm_utils import tokenizer_image_token
from teochat_torch.checkpoint.bridge import init_teochat
from teochat_torch.data.dataset import DataArguments, make_supervised_data_module
from teochat_torch.models import fusion as fusion_mod
from teochat_torch.models import llama as llama_mod
from teochat_torch.models import teochat as teochat_mod
from teochat_torch.ops import _build
from teochat_torch.ops import decode_attention as dec_mod
from teochat_torch.ops import flash_attention as flash_mod
from teochat_torch.ops import int4_matmul as int4_mod
from teochat_torch.ops import quant as quant_mod
from teochat_torch.ops import vit_attention as vit_mod
from teochat_torch.train.lora import LORA_TARGET_GROUPS, add_lora_params, lora_trainable_filter
from teochat_torch.train.train import ModelArguments, TrainingArguments, train
from teochat_torch.train.trainer import fp32_masters, partition_params, tree_leaves_with_path

SEED = 0
# |kernel (bf16 out) - plain (fp32 on the same bf16 inputs)|: outputs are
# averages of N(0, 1) values, |o| < 4, so bf16 output rounding alone is up to
# 2^-8 * 4 = 1.6e-2; P is rounded to bf16 before PV, as on the TPU
FLASH_TOL = 2e-2
DECODE_TOL = 2e-2
# ||logits(kernels) - logits(plain)|| / ||logits(plain)|| after 32 bf16 layers
LOGITS_REL_L2_BOUND = 5e-2
# The flash backward rounds P and dS to bf16 before its products and writes
# bf16 gradients (8 bits: 2^-9 relative rounding on each of many terms):
# each gradient is held to GRAD_REL_L2 of its norm and its largest error to
# GRAD_REL_MAX of its largest element
GRAD_REL_L2 = 1e-2
GRAD_REL_MAX = 2e-2
# K4b and K4c against their tile walks (flash_backward_*_schedule) on the same
# bf16 inputs, m, l and di: the same tiles, roundings and fp32 sums, so what
# differs is the order of the sums and ex2.approx against exp, which move a P
# or dS across a bf16 rounding boundary now and then, and the gradient's own
# last rounding likewise (read on an H100: relative L2 up to 2.3e-4, largest
# error up to 4.4e-3 of the largest gradient, which is one bf16 step)
WALK_REL_L2 = 1e-3
WALK_REL_MAX = 1e-2
# the di preamble against its torch line, both fp32 sums of the same 128
# exact products in another order: of the largest |di|
DI_REL_TOL = 1e-5
# K4a's m and l against the fp32 plain row maximum and sum of exp(s - m) on
# the same bf16 inputs. Scores are sums of 128 products of N(0, 1) values
# times D^-0.5, |s| < 8: the tensor cores' fp32 sum and the plain one differ
# by ~1e-5 there, which moves m by as much and each term of l by ~1e-5 of
# itself; ex2.approx adds 2e-7 relative
STAT_M_TOL = 2e-4
STAT_L_REL_TOL = 1e-3
# One 7B-width micro-step, kernels vs plain attention on the same bf16
# weights and batch: the attention differs by bf16 rounding of P and dS in
# 32 layers, the rest is the same code. The loss is a mean over ~2,000
# tokens. A gradient passes forward and back through up to 32 random bf16
# layers, which amplify the rounding. Worst leaf's relative L2, read on an
# H100 with chip_probe.py: kernels vs plain 7.9e-2 to 8.1e-2 (seeds 0, 1);
# two correct plain attentions, P rounded to bf16 or not, 7.9e-2 to 8.3e-2;
# 2.4e-2 for either pair at 4 layers. Planted faults: K4b starting one q
# tile late reads 5.0e-1, K4c without di 2.5 (the K4 phase, which holds
# each kernel's own gradients to 1e-2, fails on both as well)
TRAIN_LOSS_REL_BOUND = 1e-2
TRAIN_GRAD_REL_L2_BOUND = 1.5e-1
N_TRAIN_SAMPLES = 16
# int4 product, kernel (bf16 out) vs plain (fp32 on the same bf16 x and the
# same bytes): both accumulate exact products in fp32, so what is left is the
# kernel's one bf16 rounding of the output, at most half an ulp = 2^-8 =
# 3.9e-3 of each element (read on an H100: relative L2 1.6e-3 to 1.7e-3,
# largest error 1.7e-3 to 3.0e-3 of the largest |output| at every shape),
# plus fp32 summation order (~1e-6)
INT4_REL_L2 = 3e-3
INT4_REL_MAX = 4e-3  # largest error over the largest |output|
VIT_TOL = 2e-2  # as FLASH_TOL: bf16 output rounding of |o| < 4, P rounded to bf16
# prefill logits, int4 kernels vs plain int4_proj on the same weights and the
# same attention kernels: the two sum in another order, which flips the bf16
# rounding of a few outputs of each of the 128 projections, and 32 random
# bf16 layers amplify that as they amplify the attention's rounding above.
# Read on an H100: 3.3e-2 (the attention comparison reads 3.8e-2), the same
# argmax with a top-2 margin three times the largest logit difference. The
# K3 phase holds each product to 3e-3 at fixed shapes; this one holds the
# path's own calls (strided slices of the fused outputs, the padded fan-in at
# the prompt's M) to the order that rounding alone reaches at this depth
INT4_LOGITS_REL_L2_BOUND = 5e-2
# the 7B decoder's projections (fan-in, fan-out): q|k|v fused, out, gate|up
# fused, down (its packed fan-in padded 5504 -> 5632 byte rows), lm_head (its
# 32000 columns padded to 63 tiles of 512)
INT4_SHAPES = [("qkv", 4096, 12288), ("out", 4096, 4096), ("gateup", 4096, 22016),
               ("down", 11008, 4096), ("lm_head", 4096, 32000)]
# decode at batch 1 and 4 (the M <= 8 kernel), batched decode at 16 and the
# 2-frame prompt's prefill (the M > 8 kernel)
INT4_MS = (1, 4, 16, 768)
# torch._weight_int4pack_mm, the library's w4a16 product, against the plain
# version on the same bytes: its scales are bf16 (one more rounding of each,
# 2^-9 relative) and it rounds its own way, so it is held to 1e-2 relative L2
INT4_LIBRARY_REL_L2 = 1e-2

PROMPT_2 = ("This is a pair of satellite images of the same location taken before "
            "and after a natural disaster: <video> Identify the damaged buildings "
            "in the second image and give their bounding boxes.")
PROMPT_4 = ("These are satellite images of the same location taken at different "
            "times: <video> Has any land been cleared for construction? Answer "
            "with the image numbers.")


def log(*args):
    print(*args, flush=True)


class WordTokenizer:
    """Word-level stand-in for the LLaMA tokenizer (no tokenizer files)."""

    bos_token_id = 1
    eos_token_id = 2

    def __init__(self):
        self.vocab = {"<s>": 1, "</s>": 2}
        self.rev = {1: "<s>", 2: "</s>"}

    def __call__(self, text):
        ids = [1]
        for w in text.replace("</s>", " </s> ").split():
            if w not in self.vocab:
                self.vocab[w] = len(self.vocab) + 10
                self.rev[self.vocab[w]] = w
            ids.append(self.vocab[w])
        return types.SimpleNamespace(input_ids=ids)

    def decode(self, ids):
        return " ".join(self.rev.get(int(i), f"<{int(i)}>") for i in ids)


class FrameProcessor:
    """Seeded CLIP-normalised frames in place of decoded images."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rs = np.random.RandomState(seed)

    def preprocess(self, paths):
        if isinstance(paths, str):  # the training dataset asks for one frame at a time
            paths = [paths]
        rgb = self.rs.rand(len(paths), 3, self.size, self.size).astype(np.float32)
        mean = np.asarray(OPENAI_DATASET_MEAN, np.float32)[None, :, None, None]
        std = np.asarray(OPENAI_DATASET_STD, np.float32)[None, :, None, None]
        return {"pixel_values": (rgb - mean) / std}


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def _bhsd(x):
    """[B, S, H, D] -> the [B, H, S, D] view scaled_dot_product_attention takes."""
    return x.transpose(1, 2)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the card")
    log(_timing.smi_line())  # the card's name and power limit, as nvidia-smi gives them
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"count {torch.cuda.device_count()} name {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    t0 = time.perf_counter()
    lib = _build.library()
    log(f"[build] {lib.path.name} nvcc {lib.build_seconds:.2f}s load+total "
        f"{time.perf_counter() - t0:.2f}s")
    for line in lib.log.splitlines():
        # registers and spills of each kernel, and what ptxas warns of (an
        # ignored setmaxnreg, C7508; serialized wgmma, C7510)
        if "Compiling entry function" in line and "'" in line:
            log(f"[build] {line.split(chr(39))[1]}")  # the kernel the next lines speak of
        elif any(word in line.lower() for word in ("registers", "spill", "error", "warning")):
            log(f"[build] {line.strip()}")


def _randn(shape, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def _fused_qkv(b, s, h, hkv, d, gen):
    """q, k and v as the fused int4 q|k|v projection hands them to the
    attention: column slices of one [B, S, (H + 2 Hkv) D] output."""
    fused = _randn((b, s, (h + 2 * hkv) * d), gen)
    return (fused[..., : h * d].view(b, s, h, d),
            fused[..., h * d : (h + hkv) * d].view(b, s, hkv, d),
            fused[..., (h + hkv) * d :].view(b, s, hkv, d))


def phase_flash(gen):
    cases = [  # (B, S, T, H, Hkv, D, causal, fused); the first is reported in the JSON line
        (1, 768, 768, 32, 32, 128, True, False),  # the 2-frame prompt bucket
        (1, 600, 600, 32, 32, 128, True, False),  # ragged S
        (1, 768, 768, 32, 8, 128, True, False),  # GQA
        (4, 768, 768, 32, 32, 128, True, False),
        (1, 1536, 1536, 32, 32, 128, True, False),  # the 4-frame prompt bucket
        (4, 1536, 1536, 32, 32, 128, True, False),  # the batched generate's prefill
        (1, 768, 768, 32, 32, 128, True, True),  # v (and q, k) a strided slice of q|k|v
        (2, 768, 768, 16, 16, 64, True, False),  # head_dim 64
        (2, 40, 40, 32, 8, 128, True, False),  # S below one warpgroup's 64 rows
        (1, 9, 9, 4, 4, 64, True, False),
        (2, 300, 801, 32, 32, 128, False, False),  # non-causal, S != T, ragged T
        (2, 257, 257, 8, 2, 64, False, True),
    ]
    worst, main = 0.0, None
    for b, s, t, h, hkv, d, causal, fused in cases:
        if fused:
            q, k, v = _fused_qkv(b, s, h, hkv, d, gen)
            check(not v.is_contiguous(), "the fused case reads strided views")
        else:
            q, k, v = _randn((b, s, h, d), gen), _randn((b, t, hkv, d), gen), _randn((b, t, hkv, d), gen)
        got = flash_mod.flash_attention(q, k, v, causal=causal)
        sync()
        want = flash_mod.flash_attention_plain(q.float(), k.float(), v.float(), causal=causal)
        err = (got.float() - want).abs().max().item()
        check(torch.isfinite(got).all().item(), "flash output finite")
        ms = time_ms(lambda: flash_mod.flash_attention(q, k, v, causal=causal))
        plain_ms = time_ms(lambda: flash_mod.flash_attention_plain(q, k, v, causal=causal))
        flops = 4 * b * h * s * k.shape[1] * d / (2 if causal else 1)
        log(f"[K1 flash] B={b} S={s} T={k.shape[1]} H={h} Hkv={hkv} D={d} causal={causal} "
            f"fused={fused}: max_abs_err={err:.3e} (tol {FLASH_TOL}) kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s) plain {plain_ms:.4f} ms")
        check(err <= FLASH_TOL, f"flash error {err} > {FLASH_TOL}")
        worst = max(worst, err)
        if main is None:
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                _bhsd(q), _bhsd(k), _bhsd(v), is_causal=True))
            nbytes = 2 * (2 * b * s * h * d + 2 * b * s * hkv * d)
            main = kernel_row(None, ms, plain_ms, nbytes, flops, lib_ms)
            log(f"[K1 flash] same shape: scaled_dot_product_attention {lib_ms:.4f} ms, bound "
                f"{main['bound_ms']:.4f} ms ({main['bound_by']})")
    main["max_abs_err"] = worst
    return main


def phase_decode(gen):
    ragged = [1025, 1, 517, 1024, 64, 300, 1000, 2]
    c = dec_mod.CHUNK
    cases = [  # (B, H, Hkv, T, lengths, D); the first is reported in the JSON line
        (1, 32, 32, 801, [580], 128),  # 2-frame request: T = 768 + 32 + 1, last step
        (4, 32, 32, 1553, [1100, 1080, 1120, 60], 128),  # the batched generate's cache
        (1, 32, 32, 1025, [1025], 128),
        (8, 32, 32, 1025, ragged, 128),
        (1, 32, 8, 1025, [1025], 128),
        (8, 32, 8, 1025, ragged, 128),
        (1, 32, 2, 300, [290], 128),  # 16 query heads a kv head: two blocks of 8
        # the split's edges: 1, CHUNK - 1, CHUNK, CHUNK + 1 and T live slots
        (5, 32, 32, 801, [1, c - 1, c, c + 1, 801], 128),
        (5, 32, 8, 801, [1, c - 1, c, c + 1, 801], 128),
        (5, 16, 16, 300, [1, c - 1, c, c + 1, 300], 64),
        (3, 32, 32, 801, [0, 580, 0], 128),  # rows with no live slot are written as 0
    ]
    worst, main = 0.0, None
    for b, h, hkv, t, lengths, d in cases:
        # a layer slab of the [L, B, T, Hkv, D] cache, read in place as [B, Hkv, T, D]
        k_slab, v_slab = _randn((b, t, hkv, d), gen), _randn((b, t, hkv, d), gen)
        k, v = k_slab.transpose(1, 2), v_slab.transpose(1, 2)
        q = _randn((b, h, d), gen)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        got = dec_mod.decode_attention(q, k, v, lens)
        again = dec_mod.decode_attention(q, k, v, lens)
        sync()
        check(torch.equal(got, again), "decode: the same bits on a second call (tickets reset)")
        want = dec_mod.decode_attention_plain(q.float(), k.float(), v.float(), lens)
        live = lens > 0  # the plain twin gives the mean of V where the kernel gives 0
        check(got[~live].abs().sum().item() == 0.0, "decode: a row without live slots is 0")
        err = (got.float() - want)[live].abs().max().item()
        check(torch.isfinite(got).all().item(), "decode output finite")
        ms = time_ms(lambda: dec_mod.decode_attention(q, k, v, lens))
        plain_ms = time_ms(lambda: dec_mod.decode_attention_plain(q, k, v, lens))
        n_live = int(lens.sum().item())
        nbytes = 2 * n_live * hkv * d * 2
        lib_ms = None
        if live.all():
            mask = torch.arange(t, device="cuda")[None, :] < lens[:, None]
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None, :], k, v, attn_mask=mask[:, None, None, :], enable_gqa=hkv != h))
        row = kernel_row(err, ms, plain_ms, nbytes + 2 * 2 * b * h * d, 4 * n_live * h * d, lib_ms)
        lib_text = "n/a (a row without live slots)" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"[K2 decode] B={b} H={h} Hkv={hkv} D={d} T={t} lengths={lens.tolist()}: "
            f"max_abs_err={err:.3e} (tol {DECODE_TOL}) kernel {ms:.4f} ms "
            f"({nbytes / ms / 1e6:.1f} GB/s of live KV) plain {plain_ms:.4f} ms "
            f"scaled_dot_product_attention with the length mask {lib_text} bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        check(err <= DECODE_TOL, f"decode error {err} > {DECODE_TOL}")
        worst = max(worst, err)
        main = main or row
    main["max_abs_err"] = worst
    return main


def int4pack_library(packed, scale, n_out, copies=1):
    """`torch._weight_int4pack_mm` set up to compute what K3 computes on one
    weight's bytes (`packed`: flat [k2, N] or tiles [n_tiles, k2, TW]): the
    values repacked unsigned (v + 8) by `torch._convert_weight_to_int4pack`,
    groups of 128 rows that each carry their column's scale (in bf16), zeros
    0. Returns (prepare, call): prepare(x) pads x to the padded fan-in
    (outside the timed call), call(xp) is the product. With `copies` > 1 the
    packed weights and scales are held that many times and each call reads
    the next copy, as the kernel's timed launches walk a stack of copies
    larger than the L2. A yardstick only: the port never calls it."""
    flat = int4_mod.untile(packed) if packed.ndim == 3 else packed
    w = int4_mod.unpack_int4_any(flat[:, :n_out], torch.int32)  # [2 k2, n_out] in [-8, 7]
    q = (w + 8).t().contiguous()  # [N, K] unsigned, a row a column of W
    b = torch._convert_weight_to_int4pack((q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8), 8)
    groups = w.shape[0] // 128
    sz = torch.stack([scale[:n_out].to(torch.bfloat16).expand(groups, n_out),
                      torch.zeros((groups, n_out), dtype=torch.bfloat16, device=w.device)],
                     dim=-1)
    bs = b[None].expand(copies, *b.shape).contiguous()
    szs = sz[None].expand(copies, *sz.shape).contiguous()
    nxt = itertools.cycle(range(copies)).__next__

    def prepare(x):
        return F.pad(x, (0, w.shape[0] - x.shape[1])).contiguous()

    def call(xp):
        i = nxt()
        return torch._weight_int4pack_mm(xp, bs[i], 128, szs[i])

    return prepare, call


def _int4_library_ms(name, m, x, library, want):
    """The library call's ms on x, after holding it to INT4_LIBRARY_REL_L2 of
    the plain version; None (with the reason printed) where the card's torch
    refuses the shape."""
    if library is None:
        return None
    prepare, call = library
    xp = prepare(x)
    try:
        got = call(xp)
        sync()
    except RuntimeError as e:
        log(f"[K3 int4] {name} M={m}: torch._weight_int4pack_mm refused: {str(e)[:200]}")
        return None
    rel_l2 = ((got.float() - want).norm() / want.norm()).item()
    check(rel_l2 <= INT4_LIBRARY_REL_L2, f"{name} M={m}: library rel L2 {rel_l2}")
    return time_ms(lambda: call(xp))


def _int4_case(name, k, n, m, packed, run, plain, tag="K3 int4", scaled=True, x=None,
               library=None):
    """One int4 product (`packed`: one weight's bytes; k: the rows of x it
    meets) against its plain version, and the library's product on x where
    `library` is given; returns (abs err, ms, plain ms, bytes, flops,
    library ms or None)."""
    got = run()
    sync()
    want = plain()  # fp32: the plain version keeps the dtype of the x it is given
    check(got.shape == want.shape and got.dtype == torch.bfloat16, f"{name}: shape / dtype")
    check(torch.isfinite(got).all().item(), f"{name}: output finite")
    diff = got.float() - want
    rel_l2 = (diff.norm() / want.norm()).item()
    err, top = diff.abs().max().item(), want.abs().max().item()
    ms = time_ms(run)
    call_ms = time_ms(run, inner=1, queued=False)  # one call on an idle card, host included
    plain_ms = time_ms(plain, n=3, inner=1)
    nbytes = packed.numel() + 2 * m * k + 2 * m * n + 4 * n * scaled  # bytes, x, y, scale
    flops = 2 * m * k * n
    bound, by = bound_ms(nbytes, flops)
    lib_ms = _int4_library_ms(name, m, x, library, want)
    lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    log(f"[{tag}] {name} K={k} N={n} M={m} {str(packed.dtype)[6:]}: rel L2 {rel_l2:.3e} "
        f"(bound {INT4_REL_L2}) max_abs_err {err:.3e} = {err / top:.3e} of max |y| "
        f"(bound {INT4_REL_MAX}); kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s, "
        f"{flops / ms / 1e9:.2f} TFLOP/s; {call_ms:.4f} ms a call on an idle card) plain "
        f"{plain_ms:.4f} ms bound {bound:.4f} ms ({by}) torch._weight_int4pack_mm {lib}")
    check(rel_l2 <= INT4_REL_L2, f"{name} M={m}: rel L2 {rel_l2} > {INT4_REL_L2}")
    check(err <= INT4_REL_MAX * top, f"{name} M={m}: max err {err / top} of max > {INT4_REL_MAX}")
    return err, ms, plain_ms, nbytes, flops, lib_ms


def phase_int4(gen):
    """K3a, K3b, K3c at the 7B shapes. Weights are random kernels through the
    port's quantizer (so the K and N paddings are the real ones); timed
    launches walk a stack of copies larger than the 50 MB L2."""
    rows, worst = {}, {"k3a": 0.0, "k3b": 0.0, "k3c": 0.0, "k3c_decode": 0.0}

    def quantized(k, n):
        w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
        return quant_mod.quantize_kernel_int4(w)

    for name, k, n in INT4_SHAPES:
        a, b = quantized(k, n), quantized(k, n)
        tiles2 = torch.stack([a["packed_tiles"], b["packed_tiles"]])
        scale2 = torch.stack([a["scale"], b["scale"]])
        check(tiles2.dtype == torch.int8 and tiles2.shape[-1] == 512, f"{name}: v3 tiles of 512")
        reps = -(-160 * 2**20 // tiles2[0].numel())  # copies that exceed the L2 three times
        rot_tiles = tiles2[1:].expand(reps, -1, -1, -1).contiguous()
        rot_scale = scale2[1:].expand(reps, -1).contiguous()
        # a timed launch finds its weight out of the L2, as a decode step finds
        # each layer's; the library's timed calls walk as many copies of theirs
        nxt = itertools.cycle(range(reps)).__next__
        library = int4pack_library(b["packed_tiles"], b["scale"], n, copies=reps)
        for m in INT4_MS:
            x = _randn((m, k), gen)
            if name == "lm_head":  # K3b: one weight, tiles [63, 2048, 512]
                key, label = "k3b", "K3b lm_head"
                run = lambda: int4_mod.int4_matmul_tiled(
                    x, rot_tiles[nxt()], scale2[1], n_out=n)
                plain = lambda: int4_mod.int4_matmul_tiled_plain(
                    x.float(), tiles2[1], scale2[1], n_out=n)
            else:  # K3c: the layer picked out of the stack
                key, label = "k3c", f"K3c {name}"
                run = lambda: int4_mod.int4_matmul_tiled_stacked(
                    x, rot_tiles, rot_scale, nxt(), n_out=n)
                plain = lambda: int4_mod.int4_matmul_tiled_stacked_plain(
                    x.float(), tiles2, scale2, 1, n_out=n)
                got = int4_mod.int4_matmul_tiled_stacked(x, tiles2, scale2, 0, n_out=n)
                want = int4_mod.int4_matmul_tiled_stacked_plain(
                    x.float(), tiles2, scale2, 0, n_out=n)
                check(((got.float() - want).norm() / want.norm()).item() <= INT4_REL_L2,
                      f"{label} M={m}: layer 0 of the stack")
            if key == "k3c" and m <= int4_mod.SMALL_M:
                key = "k3c_decode"  # the same wrapper's decode kernel
            out = _int4_case(label, k, n, m, tiles2[1], run, plain, x=x, library=library)
            worst[key] = max(worst[key], out[0])
            # the rows of the JSON line: K3c's two kernels at gate|up (the
            # prefill's and decode's), K3b at decode
            if (name, m) in (("gateup", 768), ("gateup", 1), ("lm_head", 1)):
                rows[key] = kernel_row(None, *out[1:])
        if name == "out":  # K3b on u8 bytes: the v3 bytes with the top bit flipped
            u8 = (tiles2[1].view(torch.uint8) ^ 0x80).contiguous()
            x = _randn((4, k), gen)
            out = _int4_case(
                "K3b out", k, n, 4, u8,
                lambda: int4_mod.int4_matmul_tiled(x, u8, scale2[1], n_out=n),
                lambda: int4_mod.int4_matmul_tiled_plain(x.float(), u8, scale2[1], n_out=n))
            worst["k3b"] = max(worst["k3b"], out[0])
        del a, b, tiles2, rot_tiles, rot_scale, library

    # K3a: an unfused k or v of a model with 2 kv heads: K 4096, N 256, flat u8
    k, n = 4096, 256
    leaf = quantized(k, n)
    check("packed" in leaf and leaf["packed"].dtype == torch.uint8, "K3a: flat u8 leaf")
    library = int4pack_library(leaf["packed"], leaf["scale"], n)
    for m in INT4_MS:
        x = _randn((m, k), gen)
        out = _int4_case(
            "K3a flat", k, n, m, leaf["packed"],
            lambda: int4_mod.int4_matmul(x, leaf["packed"], leaf["scale"]),
            lambda: int4_mod.int4_matmul_plain(x.float(), leaf["packed"], leaf["scale"]),
            x=x, library=library)
        worst["k3a"] = max(worst["k3a"], out[0])
        if m == 768:
            rows["k3a"] = kernel_row(None, *out[1:])
    for key in rows:
        rows[key]["max_abs_err"] = worst[key]
    return rows


def phase_vit_attention(gen):
    cases = [  # (B, S, H, D); the first is reported in the JSON line
        (2, 257, 16, 64),  # a 2-frame request's encode
        (32, 257, 16, 64),
        (3, 100, 16, 64),  # ragged against every tile
        (16, 1024, 16, 64),  # the longest the gate lets through
        (4, 577, 16, 64),  # a 336-pixel tower: three windows of keys
        (2, 577, 16, 64),
    ]
    worst, main = 0.0, None
    for b, s, h, d in cases:
        q, k, v = (_randn((b, s, h, d), gen) for _ in range(3))
        got = vit_mod.vit_attention(q, k, v)
        sync()
        want = vit_mod.vit_attention_plain(q.float(), k.float(), v.float())
        err = (got.float() - want).abs().max().item()
        check(torch.isfinite(got).all().item(), "vit attention output finite")
        ms = time_ms(lambda: vit_mod.vit_attention(q, k, v))
        plain_ms = time_ms(lambda: vit_mod.vit_attention_plain(q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(_bhsd(q), _bhsd(k), _bhsd(v)))
        flops, nbytes = 4 * b * h * s * s * d, 2 * 4 * b * s * h * d
        row = kernel_row(err, ms, plain_ms, nbytes, flops, lib_ms)
        log(f"[K5 vit attention] B={b} S={s} H={h} D={d}: max_abs_err={err:.3e} (tol {VIT_TOL}) "
            f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s) plain {plain_ms:.4f} ms "
            f"scaled_dot_product_attention {lib_ms:.4f} ms bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")
        check(err <= VIT_TOL, f"vit attention error {err} > {VIT_TOL}")
        worst = max(worst, err)
        main = main or row
    main["max_abs_err"] = worst
    return main


INFERENCE_COUNTERS = {  # the kernels an inference path may launch
    "K1": flash_mod.LAUNCHES, "K2": dec_mod.LAUNCHES, "K3a": int4_mod.LAUNCHES_FLAT,
    "K3b": int4_mod.LAUNCHES_TILED, "K3c": int4_mod.LAUNCHES_STACKED,
    "K3c M<=8": int4_mod.LAUNCHES_STACKED_SMALL_M, "K5": vit_mod.LAUNCHES,
}


def counted(tag, fn):
    """Run one path with every inference kernel's count set to 0 just before
    it and read just after; returns (fn's result, {kernel: launches})."""
    for counter in INFERENCE_COUNTERS.values():
        counter.reset()
    out = fn()
    counts = {name: c.count for name, c in INFERENCE_COUNTERS.items()}
    log(f"[{tag}] kernel launches on this path: "
        + ", ".join(f"{name} {n}" for name, n in counts.items())
        + f"; peak allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return out, counts


def phase_main_path(model, tokenizer, processor, tag="main"):
    cfg = model.cfg
    requests = [
        ("2-frame greedy", PROMPT_2, 2, 0.0),
        ("4-frame greedy", PROMPT_4, 4, 0.0),
        ("2-frame t=0.2", PROMPT_2, 2, 0.2),
    ]
    for name, prompt, n_frames, temp in requests:
        paths = [f"frame_{i}.png" for i in range(n_frames)]
        stamps = [f"2019-0{i + 1}-15" for i in range(n_frames)]
        answer, sec = wall(lambda: run_inference_single(
            model, processor, tokenizer, prompt, paths, timestamps=stamps,
            temperature=temp, max_new_tokens=32, rng=SEED + 1,
        ))
        check(isinstance(answer, str) and answer, f"{name}: empty answer")
        log(f"[{tag}] request {name}: {sec:.3f} s answer={answer[:160]!r}")

    # per-phase times of the 2-frame greedy request, from the same entry points
    frames = processor.preprocess(["a", "b"])["pixel_values"]
    ids = tokenizer_image_token(
        PROMPT_2.replace("<video>", "Image 1: <image> Image 2: <image>"), tokenizer,
        IMAGE_TOKEN_INDEX)
    toks, encode_s = wall(lambda: model.encode(frames))
    check(tuple(toks.shape) == (2, model.tokens_per_frame, cfg.llm.hidden_size)
          and torch.isfinite(toks).all().item(), "encode output")
    g1 = GenerationConfig(max_new_tokens=1, temperature=0.0, do_sample=False, stop_strings=())
    g32 = GenerationConfig(max_new_tokens=32, temperature=0.0, do_sample=False, stop_strings=())
    # host time spreads from one generate to the next: the median of three
    ttfts, fulls = [], []
    for _ in range(3):
        ttfts.append(wall(lambda: model.generate([ids], frames, g1))[1])
        out, full_s = wall(lambda: model.generate([ids], frames, g32))
        fulls.append(full_s)
    ttft_s, full_s = statistics.median(ttfts), statistics.median(fulls)
    steps = len(out[0]) - 1
    log(f"[{tag}] 2-frame bs1: encode {encode_s * 1e3:.2f} ms, TTFT {ttft_s * 1e3:.2f} ms "
        f"(encode + fuse + prefill + first token), decode {steps} steps "
        f"{steps / (full_s - ttft_s):.2f} tok/s ({(full_s - ttft_s) / steps * 1e3:.2f} ms/step); "
        f"TTFT and decode from the medians of 3 generates of 1 and of 32 tokens "
        f"(32 tokens: {min(fulls):.3f}-{max(fulls):.3f} s)")

    # one batched generate of four ragged rows (2, 1, 4 and 0 frames)
    rows = [
        (PROMPT_2.replace("<video>", "Image 1: <image> Image 2: <image>"), 2),
        ("Describe the land use in this image: <image>", 1),
        (PROMPT_4.replace("<video>", " ".join(f"Image {i + 1}: <image>" for i in range(4))), 4),
        ("What is a satellite image?", 0),
    ]
    batch_ids = [tokenizer_image_token(p, tokenizer, IMAGE_TOKEN_INDEX) for p, _ in rows]
    batch_frames = np.concatenate(
        [processor.preprocess(["x"] * n)["pixel_values"] for _, n in rows if n], axis=0)
    g16 = GenerationConfig(max_new_tokens=16, temperature=0.0, do_sample=False)
    outs, sec = wall(lambda: model.generate(batch_ids, batch_frames, g16, rng=SEED))
    check(len(outs) == 4 and all(0 < len(r) <= 16 for r in outs), "batched lengths")
    check(all(0 <= t < cfg.llm.vocab_size for r in outs for t in r), "batched token ids")
    log(f"[{tag}] batched generate of 4 ragged rows (prompt lengths "
        f"{[len(r) for r in batch_ids]}): {sec:.3f} s, tokens per row {[len(r) for r in outs]}")
    return ids, frames


@contextlib.contextmanager
def plain_int4():
    """Route every int4 product to its plain version, also on the card."""
    names = ("int4_matmul", "int4_matmul_tiled", "int4_matmul_tiled_stacked")
    saved = {name: getattr(int4_mod, name) for name in names}
    for name in names:
        setattr(int4_mod, name, functools.partial(saved[name], impl="plain"))
    try:
        yield
    finally:
        for name in names:
            setattr(int4_mod, name, saved[name])


def phase_logits(model, ids, frames, compare="attention"):
    """Last-position prefill logits of the 2-frame request, kernels against
    plain: `compare` = 'attention' (flash kernel vs plain attention) or
    'int4' (int4 kernels vs plain int4_proj, the attention kernels in both)."""
    cfg = model.cfg
    vision = model.encode(frames)
    tpf = model.tokens_per_frame
    fused = len(ids) + sum(t == IMAGE_TOKEN_INDEX for t in ids) * (tpf - 1)
    pad_to = teochat_mod.round_to_bucket(fused, teochat_mod.SEQ_BUCKETS)
    plan = fusion_mod.build_fusion_plan([ids], tokens_per_frame=tpf, pad_to=pad_to,
                                        max_length=cfg.tokenizer_model_max_length)
    embeds = teochat_mod.multimodal_embeds(model.params, cfg, plan, vision)
    pos = torch.as_tensor(plan.position_ids, device="cuda")
    last = torch.as_tensor(plan.seq_lens, device="cuda") - 1
    logits = {}
    for impl in ("auto", "plain"):
        cache = llama_mod.init_cache(cfg.llm, 1, pad_to + 2, dtype=torch.bfloat16, device="cuda")
        with plain_int4() if (compare, impl) == ("int4", "plain") else contextlib.nullcontext():
            logits[impl] = llama_mod.llama_forward(
                model.params["llm"], cfg.llm, embeds, position_ids=pos, cache=cache,
                write_slots=pos, logits_mode="last", last_index=last,
                attn_impl=impl if compare == "attention" else "auto",
            )[0, -1]
    a, b = logits["auto"], logits["plain"]
    check(tuple(a.shape) == (cfg.llm.vocab_size,) and torch.isfinite(a).all().item(),
          "logits finite")
    rel = ((a - b).norm() / b.norm()).item()
    bound = LOGITS_REL_L2_BOUND if compare == "attention" else INT4_LOGITS_REL_L2_BOUND
    what = "plain attention" if compare == "attention" else "plain int4_proj"
    top2 = torch.topk(b, 2).values
    margin, worst = (top2[0] - top2[1]).item(), (a - b).abs().max().item()
    log(f"[logits {compare}] 2-frame prefill (S={pad_to}, {plan.seq_lens[0]} live) "
        f"last-position logits, kernels vs {what}: rel L2 {rel:.3e} (bound {bound}), "
        f"argmax {int(a.argmax())} vs {int(b.argmax())} (plain's top-2 margin {margin:.3e}, "
        f"largest logit difference {worst:.3e})")
    check(rel <= bound, f"logits rel L2 {rel} > {bound}")
    if compare == "int4":  # the same token, unless the two best are closer than the error
        check(int(a.argmax()) == int(b.argmax()) or margin <= 2 * worst,
              "int4 kernels and plain int4_proj pick different tokens")


def _flash_grads(fn, q, k, v, do):
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    o = fn(q, k, v)
    o.backward(do.to(o.dtype))
    return [x.detach().float() for x in (o, q.grad, k.grad, v.grad)]


def _flash_statistics_errors(q, k, v, causal):
    """K4a's m and l (which K4b and K4c take as they are) against the plain
    row maximum and sum: (largest |m - plain|, largest |l - plain| / plain)."""
    _, m, l = flash_mod._fwd_res_cuda(q, k, v, causal, q.shape[-1] ** -0.5)
    sync()
    want_m, want_l = flash_mod.flash_statistics_plain(q.float(), k.float(), v.float(),
                                                      causal=causal)
    m_err = (m - want_m).abs().max().item()
    l_err = ((l - want_l).abs() / want_l).max().item()
    check(m_err <= STAT_M_TOL, f"K4a row maximum off by {m_err} > {STAT_M_TOL}")
    check(l_err <= STAT_L_REL_TOL, f"K4a denominator off by {l_err} > {STAT_L_REL_TOL}")
    return m_err, l_err


def _check_grad(name, got, want, l2_bound, max_bound):
    """Hold one gradient to its relative L2 and relative largest error."""
    r2 = ((got - want).norm() / want.norm()).item()
    rmax = (got - want).abs().max().item() / want.abs().max().item()
    check(r2 <= l2_bound and rmax <= max_bound,
          f"{name}: rel L2 {r2} (bound {l2_bound}), rel max {rmax} (bound {max_bound})")
    return f"{name} rel L2 {r2:.3e} rel max {rmax:.3e}"


def _flash_backward_against_schedules(q, k, v, do, causal):
    """di, K4b and K4c from K4a's saved residuals against the preamble's torch
    line and the two tile walks on the same bf16 inputs."""
    scale = q.shape[-1] ** -0.5
    o, m, l = flash_mod._fwd_res_cuda(q, k, v, causal, scale)
    di = flash_mod._bwd_di_cuda(o, do)
    sync()
    want_di = flash_mod.flash_di_plain(o, do)
    di_err = (di - want_di).abs().max().item() / want_di.abs().max().item()
    check(di_err <= DI_REL_TOL, f"di off by {di_err} of its largest (bound {DI_REL_TOL})")
    dk, dv = flash_mod._bwd_dkv_cuda(q, k, v, do, m, l, di, causal, scale)
    dq = flash_mod._bwd_dq_cuda(q, k, v, do, m, l, di, causal, scale)
    sync()
    want_dk, want_dv = flash_mod.flash_backward_dkv_schedule(q, k, v, do, m, l, want_di,
                                                             causal=causal)
    want_dq = flash_mod.flash_backward_dq_schedule(q, k, v, do, m, l, want_di, causal=causal)
    rel = [_check_grad(name, g.float(), w.float(), WALK_REL_L2, WALK_REL_MAX)
           for name, g, w in (("dq", dq, want_dq), ("dk", dk, want_dk), ("dv", dv, want_dv))]
    return f"di rel max {di_err:.3e} (bound {DI_REL_TOL}); vs tile walks: " + "; ".join(rel)


def phase_flash_backward(gen):
    cases = [  # (B, S, T, H, Hkv, D, causal, how); the first is reported in the JSON line
        (4, 1024, 1024, 32, 32, 128, True, ""),  # the training batch
        (1, 600, 600, 32, 32, 128, True, "padded"),  # ragged S, through the padded wrapper
        (1, 1024, 1024, 32, 8, 128, True, ""),  # GQA
        (1, 2048, 2048, 32, 32, 128, True, ""),
        (2, 300, 801, 32, 32, 128, False, ""),  # non-causal, S != T, both ragged
        (2, 801, 300, 8, 2, 64, False, ""),  # the same at head_dim 64 with GQA
        (2, 768, 768, 16, 16, 64, True, ""),  # head_dim 64
        # the last q tile (of 64 and of 128 rows) and the last kv tile part-filled
        (1, 1000, 1000, 32, 8, 128, True, "padded"),
        (2, 40, 40, 32, 8, 128, True, "padded"),  # below one tile
        (1, 768, 768, 32, 32, 128, True, "fused"),  # strided slices of a fused q|k|v
    ]
    worst = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
    rows = None
    for b, s, t, h, hkv, d, causal, how in cases:
        if how == "fused":
            q, k, v = _fused_qkv(b, s, h, hkv, d, gen)
            check(not v.is_contiguous(), "the fused case reads strided views")
        else:
            q, k, v = (_randn((b, s, h, d), gen), _randn((b, t, hkv, d), gen),
                       _randn((b, t, hkv, d), gen))
        do = _randn((b, s, h, d), gen)
        if how == "padded":
            fn = flash_mod.flash_attention_trainable_padded
        else:
            fn = functools.partial(flash_mod.flash_attention_trainable, causal=causal)
        got = _flash_grads(fn, q, k, v, do)
        sync()
        want = _flash_grads(lambda q, k, v: flash_mod.flash_attention_plain(
            q.float(), k.float(), v.float(), causal=causal), q, k, v, do)
        errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
        check(all(torch.isfinite(g).all().item() for g in got), "flash backward finite")
        check(errs[0] <= FLASH_TOL, f"K4a output error {errs[0]} > {FLASH_TOL}")
        stat_errs = _flash_statistics_errors(q, k, v, causal)
        rel = [_check_grad(name, g, w, GRAD_REL_L2, GRAD_REL_MAX)
               for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:])]
        walks = _flash_backward_against_schedules(q, k, v, do, causal)
        worst["fwd"] = max(worst["fwd"], errs[0])
        worst["dq"] = max(worst["dq"], errs[1])
        worst["dkv"] = max(worst["dkv"], errs[2], errs[3])
        log(f"[K4 flash train] B={b} S={s} T={t} H={h} Hkv={hkv} D={d} causal={causal} {how}: "
            f"o max_abs_err {errs[0]:.3e}; m max_abs_err {stat_errs[0]:.3e} (tol {STAT_M_TOL}), "
            f"l max rel err {stat_errs[1]:.3e} (tol {STAT_L_REL_TOL}); dq/dk/dv max_abs_err "
            f"{errs[1]:.3e}/{errs[2]:.3e}/{errs[3]:.3e}; " + "; ".join(rel) + "; " + walks)
        if rows is None:
            rows = _time_flash_backward(q, k, v, do)
    for name, row in rows.items():
        row["max_abs_err"] = worst[name]
    return rows


def _time_flash_backward(q, k, v, do):
    """Each K4 kernel alone (the backward ones and the di preamble from saved
    residuals), the plain forward and backward and
    scaled_dot_product_attention's, at one shape; returns each kernel's row
    for the JSON line."""
    b, s, h, d = q.shape
    scale = d ** -0.5
    o, m, l = flash_mod._fwd_res_cuda(q, k, v, True, scale)
    di = flash_mod._bwd_di_cuda(o, do)
    t = {
        "fwd": time_ms(lambda: flash_mod._fwd_res_cuda(q, k, v, True, scale)),
        "di": time_ms(lambda: flash_mod._bwd_di_cuda(o, do)),
        "plain_di": time_ms(lambda: flash_mod.flash_di_plain(o, do)),
        "dkv": time_ms(lambda: flash_mod._bwd_dkv_cuda(q, k, v, do, m, l, di, True, scale)),
        "dq": time_ms(lambda: flash_mod._bwd_dq_cuda(q, k, v, do, m, l, di, True, scale)),
        "bwd": time_ms(lambda: flash_mod._bwd_cuda(q, k, v, o, m, l, do, True, scale)),
        "plain_fwd": time_ms(lambda: flash_mod.flash_attention_plain(q, k, v)),
    }
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    op = flash_mod.flash_attention_plain(qg, kg, vg)
    t["plain_bwd"] = time_ms(lambda: torch.autograd.grad(op, (qg, kg, vg), do, retain_graph=True))
    qt, kt, vt = (_bhsd(x).detach().requires_grad_(True) for x in (q, k, v))
    t["lib_fwd"] = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    ol = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    t["lib_bwd"] = time_ms(
        lambda: torch.autograd.grad(ol, (qt, kt, vt), _bhsd(do), retain_graph=True))
    product = 2 * b * h * s * s * d / 2  # one causal S x S x D product
    tensor, stat = 2 * q.numel(), 4 * b * h * s  # bytes of a bf16 [B, S, H, D], of an fp32 [B, H, S]
    together = t["di"] + t["dkv"] + t["dq"]
    log(f"[K4 flash train] B={b} S={s} H={h} D={d} times: K4a {t['fwd']:.4f} ms "
        f"({2 * product / t['fwd'] / 1e9:.1f} TFLOP/s), K4b {t['dkv']:.4f} ms "
        f"({4 * product / t['dkv'] / 1e9:.1f} TFLOP/s), K4c {t['dq']:.4f} ms "
        f"({3 * product / t['dq'] / 1e9:.1f} TFLOP/s), di {t['di']:.4f} ms (its torch line "
        f"{t['plain_di']:.4f} ms, bytes bound {bound_ms(2 * tensor + stat, 0)[0]:.4f} ms); "
        f"di + K4b + K4c {together:.4f} ms, the three launched back to back {t['bwd']:.4f} ms; "
        f"plain forward {t['plain_fwd']:.4f} ms, plain backward {t['plain_bwd']:.4f} ms; "
        f"scaled_dot_product_attention forward {t['lib_fwd']:.4f} ms, backward (dq, dk and dv "
        f"in one call, its own di included) {t['lib_bwd']:.4f} ms: {together / t['lib_bwd']:.2f}x")
    # bytes: bf16 [B, S, H, D] tensors in and out, fp32 [B, H, S] statistics;
    # operations: the products each kernel's function needs from its inputs
    # (K4a: S and PV; K4b: S, dP, dV, dK; K4c: S, dP, dQ), causal halves
    return {
        "fwd": kernel_row(None, t["fwd"], t["plain_fwd"], 4 * tensor + 2 * stat, 2 * product,
                          t["lib_fwd"]),
        "dkv": kernel_row(None, t["dkv"], t["plain_bwd"], 6 * tensor + 3 * stat, 4 * product,
                          t["lib_bwd"]),
        "dq": kernel_row(None, t["dq"], t["plain_bwd"], 5 * tensor + 3 * stat, 3 * product,
                         t["lib_bwd"]),
    }


TRAIN_QA = [
    ("Identify the damaged buildings in the second image and give their bounding boxes.",
     "There are three damaged buildings: [12, 40, 20, 48], [51, 8, 60, 17] and [70, 70, 79, 80]."),
    ("Was any building destroyed? Answer yes or no.", "Yes."),
    ("Classify the damage to the building at [33, 20, 41, 29].",
     "The building at [33, 20, 41, 29] shows major damage: part of its roof is gone."),
    ("What type of disaster happened between the two images?",
     "A flood: water covers the roads and the fields in the second image."),
]


def train_samples(n: int):
    """n synthetic xBD-style 2-frame conversations: a question and an answer."""
    out = []
    for i in range(n):
        q, a = TRAIN_QA[i % len(TRAIN_QA)]
        out.append({
            "conversations": [
                {"from": "human", "value": PROMPT_2.split("<video>")[0] + f"<video> {q}"},
                {"from": "gpt", "value": a},
            ],
            "video": [f"pre_disaster_{i}.png", f"post_disaster_{i}.png"],
            "timestamp": ["2019-01-15", "2019-03-15"],
        })
    return out


def _k4_counts():
    return {"fwd": flash_mod.FWD_RES_LAUNCHES.count, "dkv": flash_mod.BWD_DKV_LAUNCHES.count,
            "dq": flash_mod.BWD_DQ_LAUNCHES.count}


def phase_train(cfg, params, tokenizer, processor):
    before = {p: x.float() for p, x in tree_leaves_with_path(params["projector"])}
    targs = TrainingArguments(
        per_device_train_batch_size=4, gradient_accumulation_steps=2, learning_rate=2e-4,
        mm_projector_lr=2e-5, lr_scheduler_type="cosine", warmup_ratio=0.03, max_grad_norm=1.0,
        gradient_checkpointing=True, max_steps=3, num_train_epochs=2, save_strategy="no",
        logging_steps=1, lora_r=128, lora_alpha=256.0, bf16=True, seed=SEED,
    )
    history = []
    flash_mod.FWD_RES_LAUNCHES.reset()
    flash_mod.BWD_DKV_LAUNCHES.reset()
    flash_mod.BWD_DQ_LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats()
    state, sec = wall(lambda: train(
        ModelArguments(), DataArguments(image_processor=processor), targs, cfg=cfg,
        params=params, tokenizer=tokenizer, dataset=train_samples(N_TRAIN_SAMPLES),
        history=history))
    counts = _k4_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    micro = targs.max_steps * targs.gradient_accumulation_steps
    check(len(history) == targs.max_steps and state.step == micro, "three optimizer steps")
    check(all(np.isfinite(h["loss"]) for h in history), "training losses finite")
    for h in history:
        log(f"[train] step {h['step']}: loss {h['loss']:.6f}, {h['seconds']:.3f} s, "
            f"{h['tokens'] / h['seconds']:.1f} tokens/s ({h['tokens']} valid of "
            f"{h['padded_tokens']} padded tokens, {targs.gradient_accumulation_steps} micro-batches)")
    steady = history[1:]
    s_step = sum(h["seconds"] for h in steady) / len(steady)
    tok_s = sum(h["tokens"] for h in steady) / sum(h["seconds"] for h in steady)
    log(f"[train] TEOChat-7B int8 + LoRA r128: {sec:.2f} s for {len(history)} steps; steps 2-3: "
        f"{s_step:.3f} s/step, {tok_s:.1f} valid tokens/s; peak allocated {peak:.3f} GiB")
    log(f"[train] kernel launches during train(): K4a {counts['fwd']}, K4b {counts['dkv']}, "
        f"K4c {counts['dq']} over {micro} micro-steps of {cfg.llm.num_layers} layers")
    layers = cfg.llm.num_layers * micro
    check(counts["fwd"] >= layers and counts["dkv"] >= layers and counts["dq"] >= layers,
          f"K4 launches {counts} below {layers}")

    # every adapter and projector leaf moved (A from its seeded draw, B from 0)
    dev = params["llm"]["embed_tokens"]["embedding"].device
    init_lora = add_lora_params(torch.Generator(device=dev).manual_seed(SEED),
                                params["llm"], rank=targs.lora_r, alpha=targs.lora_alpha)
    want = dict(tree_leaves_with_path(partition_params(
        {"llm": init_lora}, lora_trainable_filter)[0]))
    got = dict(tree_leaves_with_path(partition_params(
        {"llm": state.params["llm"]}, lora_trainable_filter)[0]))
    check(sorted(got) == sorted(want) and len(got) == 14, "LoRA leaves")
    for path, x in got.items():
        check(not torch.equal(x, want[path]), f"{path} did not change")
    del init_lora, want
    for path, x in tree_leaves_with_path(state.params["projector"]):
        check(not torch.equal(x, before[path]), f"projector/{path} did not change")
    return counts


def parity_batch(cfg, params, tokenizer, processor, gen):
    """The parity phase's inputs: params with fp32 LoRA (B drawn nonzero from
    `gen`, so every adapter gets a gradient) and projector masters, their
    trainable leaves by path, and one 4-row batch of `train_samples`."""
    dev = params["llm"]["embed_tokens"]["embedding"].device
    llm = add_lora_params(gen, params["llm"], rank=128, alpha=256.0)
    for group in LORA_TARGET_GROUPS:
        for proj in llm["layers"][group].values():
            proj["lora_b"] = torch.randn(proj["lora_b"].shape, generator=gen, device=dev) * 1e-3
    params = fp32_masters({**params, "llm": llm}, lora_trainable_filter)
    module = make_supervised_data_module(
        tokenizer, DataArguments(image_processor=processor),
        tokens_per_frame=cfg.vision.num_patches, max_length=cfg.tokenizer_model_max_length,
        dataset=train_samples(4))
    ds = module["train_dataset"]
    plan, pixels = module["data_collator"]([ds[i] for i in range(len(ds))])
    pixels = torch.as_tensor(pixels).to(dev, torch.bfloat16)
    leaves = dict(tree_leaves_with_path(partition_params(params, lora_trainable_filter)[0]))
    for x in leaves.values():
        x.requires_grad_(True)
    return params, leaves, plan, pixels


def micro_step(cfg, params, leaves, plan, pixels, impl):
    """One micro-step's loss and trainable gradients (remat on, as in training)."""
    loss = teochat_mod.forward_train(params, cfg, plan, pixels, remat=True, attn_impl=impl)
    return loss.item(), torch.autograd.grad(loss, list(leaves.values()))


def compare_steps(leaves, got, want):
    """(loss relative difference, gradients' relative L2 over all leaves,
    {path: each leaf's relative L2}) of two micro_step results."""
    (la, ga), (lb, gb) = got, want
    rels = {path: ((a.float() - b.float()).norm() / b.float().norm()).item()
            for path, a, b in zip(leaves, ga, gb)}
    total = (sum((a.float() - b.float()).pow(2).sum() for a, b in zip(ga, gb)).sqrt()
             / sum(b.float().pow(2).sum() for b in gb).sqrt()).item()
    return abs(la - lb) / abs(lb), total, rels


def phase_train_parity(cfg, params, tokenizer, processor, gen):
    """One micro-step at full width, kernels vs plain attention, LoRA B nonzero."""
    params, leaves, plan, pixels = parity_batch(cfg, params, tokenizer, processor, gen)
    got = micro_step(cfg, params, leaves, plan, pixels, "auto")
    want = micro_step(cfg, params, leaves, plan, pixels, "plain")
    check(np.isfinite(got[0]) and all(torch.isfinite(g).all().item() for g in got[1]),
          "parity finite")
    loss_rel, total, rels = compare_steps(leaves, got, want)
    worst_path = max(rels, key=rels.get)
    log(f"[train parity] B={plan.labels.shape[0]} S={plan.labels.shape[1]} one micro-step, "
        f"kernels vs plain attention: loss {got[0]:.6f} vs {want[0]:.6f}, rel diff "
        f"{loss_rel:.3e} (bound {TRAIN_LOSS_REL_BOUND}); gradients rel L2 {total:.3e} over all "
        f"{len(rels)} trainable leaves, worst leaf {worst_path} {rels[worst_path]:.3e} "
        f"(bound {TRAIN_GRAD_REL_L2_BOUND})")
    check(loss_rel <= TRAIN_LOSS_REL_BOUND, f"loss rel diff {loss_rel}")
    check(rels[worst_path] <= TRAIN_GRAD_REL_L2_BOUND, f"gradient rel L2 {rels[worst_path]}")


def phase_k3a_path(cfg, gen, tokenizer, processor):
    """One request through a 4-layer decoder at 7B width with 2 kv heads and
    unfused int4 projections: k and v are 256 wide, so flat `packed` leaves."""
    llm = dataclasses.replace(cfg.llm, num_layers=4, num_kv_heads=2)
    cfg = dataclasses.replace(cfg, llm=llm)
    params = init_teochat(cfg, gen, "cuda", torch.bfloat16, quant="int4", fuse_projections=False)
    attn = params["llm"]["layers"]["attn"]
    check(attn["k"]["packed"].shape == (4, 2048, 256) and "packed_tiles" in attn["q"],
          "flat k and v beside tiled q")
    model = teochat_mod.TEOChat(cfg, params, tokenizer=tokenizer)

    def request():
        return wall(lambda: run_inference_single(
            model, processor, tokenizer, PROMPT_2, ["a.png", "b.png"],
            timestamps=["2019-01-15", "2019-02-15"], temperature=0.0, max_new_tokens=8))

    (answer, sec), counts = counted("K3a path", request)
    check(isinstance(answer, str) and answer, "K3a path: empty answer")
    log(f"[K3a path] 4 layers, 2 kv heads, unfused int4: {sec:.3f} s answer={answer[:80]!r}")
    # a layer runs 5 tiled projections (q, out, gate, up, down) and 2 flat ones (k, v)
    check(counts["K3a"] > 0 and counts["K3a"] * 5 == counts["K3c"] * 2, f"K3a launches {counts}")
    check(counts["K2"] > 0 and counts["K3b"] > 0, f"decode steps and the lm_head ran {counts}")
    return counts


def phase_int4_path(gen, tokenizer):
    """The int4 inference path at full width and depth, then its logits check."""
    cfg = TEOChatConfig()
    torch.cuda.reset_peak_memory_stats()
    params, init_s = wall(lambda: init_teochat(cfg, gen, "cuda", torch.bfloat16, quant="int4"))
    log(f"[int4] init TEOChat-7B int4 (fused q|k|v and gate|up, int4 lm_head; random, seed "
        f"{SEED}): {init_s:.2f} s, allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    model = teochat_mod.TEOChat(cfg, params, tokenizer=tokenizer)
    processor = FrameProcessor(cfg.vision.image_size, SEED)
    (ids, frames), counts = counted(
        "int4", lambda: phase_main_path(model, tokenizer, processor, tag="int4"))
    check(all(counts[k] > 0 for k in ("K1", "K2", "K3b", "K3c M<=8", "K5"))
          and counts["K3c"] > counts["K3c M<=8"] and counts["K3a"] == 0,
          f"int4 path launches (prefill and decode both run K3c) {counts}")
    # every forward runs 4 stacked projections in each layer and one lm_head;
    # every encode runs the 23 layers below the selected one
    n_layers, vit_layers = cfg.llm.num_layers, cfg.vision.num_layers - 1
    check(counts["K3c"] == 4 * n_layers * counts["K3b"], f"K3c per forward {counts}")
    check(counts["K5"] % vit_layers == 0, f"K5 per encode {counts}")
    phase_logits(model, ids, frames, compare="int4")
    k3a_counts = phase_k3a_path(cfg, gen, tokenizer, processor)
    return counts, k3a_counts


def phase_bench_int4(gen):
    """S1: the six kernels of the int4 kernel bench at the gate projection
    (K 4096, N 11008, tiles of 512), M = 1 and 8, held as tight as K3 (both
    sides sum the same exact products in fp32). The byte-reuse kernels get xa
    and xb made beforehand, as their plain versions do, so both round the same
    way; a timed launch finds its tiles out of the L2."""
    k, n = bench_int4.K, bench_int4.N
    w_q = torch.randint(-8, 8, (k, n), generator=gen, device="cuda").to(torch.int8)
    scale = torch.rand((n,), generator=gen, device="cuda") * 0.01
    tiles, tiles_i8 = int4_mod.pack_int4_tiled(w_q), bench_int4.pack_int4_i8(w_q)
    tiles_i4 = bench_int4.pack_int4_native(w_q)
    rows, worst = {}, {}
    # the library's product on the same weights (v2-v5 compute x @ unpack *
    # scale); its timed calls walk copies that exceed the L2 three times
    reps = -(-160 * 2**20 // tiles.numel())
    library = int4pack_library(tiles, scale, n, copies=reps)
    for m in (1, 8):
        x = _randn((m, k), gen)
        ops = bench_int4.byte_reuse_operands(x, k // 2)
        cases = [  # (key, tiles, kernel(tiles), plain())
            ("S1-v2", tiles,
             lambda t: bench_int4.v2_matmul(x, t, scale, n_out=n, operands=ops),
             lambda: bench_int4.v2_matmul_plain(x.float(), tiles, scale, n_out=n, operands=ops)),
            ("S1-v3", tiles_i8,
             lambda t: bench_int4.v3_matmul(x, t, scale, n_out=n, operands=ops),
             lambda: bench_int4.v3_matmul_plain(x.float(), tiles_i8, scale, n_out=n,
                                                operands=ops)),
            ("S1-v3 mask16", tiles_i8,
             lambda t: bench_int4.v3_matmul(x, t, scale, n_out=n, mask_dtype=torch.int16,
                                            operands=ops),
             lambda: bench_int4.v3_matmul_plain(x.float(), tiles_i8, scale, n_out=n,
                                                mask_dtype=torch.int16, operands=ops)),
            ("S1-v5", tiles_i8,
             lambda t: bench_int4.v5_matmul(x, t, scale, n_out=n, operands=ops),
             lambda: bench_int4.v5_matmul_plain(x.float(), tiles_i8, scale, n_out=n,
                                                operands=ops)),
            ("S1-v4", tiles_i4,
             lambda t: bench_int4.v4_matmul(x, t, scale, n_out=n),
             lambda: bench_int4.v4_matmul_plain(x.float(), tiles_i4, scale, n_out=n)),
            ("S1-dma", tiles,
             lambda t: bench_int4.dma_only_matmul(x, t, n_out=n),
             lambda: bench_int4.dma_only_matmul_plain(x.float(), tiles, n_out=n)),
        ]
        for key, t0, kernel, plain in cases:
            nxt = _timing.rotation(t0)
            dma = key == "S1-dma"  # half of x, no scale
            # the library beside v4 (its plain version is the exact product) at M 1, and
            # beside v2 and v5 at both M; it is held to each variant's plain version
            lib = library if key in ("S1-v2", "S1-v5") or (key, m) == ("S1-v4", 1) else None
            out = _int4_case(key, k // 2 if dma else k, n, m, t0, lambda: kernel(nxt()), plain,
                             tag="S1 int4 bench", scaled=not dma, x=x, library=lib)
            key = key.split()[0]  # the mask16 case counts toward S1-v3's error
            worst[key] = max(worst.get(key, 0.0), out[0])
            if m == 1 and key not in rows:
                rows[key] = kernel_row(None, *out[1:])
    # the unpack probe: exact small integers, so the column sums are equal
    nxt = _timing.rotation(tiles)
    cols, total = bench_int4.vpu_only(tiles)
    sync()
    want_cols, want_total = bench_int4.vpu_only_plain(tiles)
    err = (cols - want_cols).abs().max().item()
    check(err == 0.0 and cols.shape == (tiles.shape[0], tiles.shape[2]),
          f"S1-vpu: column sums differ by {err}")
    check(abs(total.item() - want_total.item()) <= 1e-6 * abs(want_total.item()), "S1-vpu: total")
    ms = time_ms(lambda: bench_int4.vpu_only(nxt())[0])
    plain_ms = time_ms(lambda: bench_int4.vpu_only_plain(tiles)[0], n=3, inner=1)
    nbytes = tiles.numel() + 4 * cols.numel()
    rows["S1-vpu"] = kernel_row(err, ms, plain_ms, nbytes, 2 * 2 * tiles.numel())
    # the call is the kernel then the torch total, as the plain version's; beside it the kernel
    alone_ms = rows["S1-vpu"]["kernel_alone_ms"] = time_ms(
        lambda: bench_int4.vpu_column_sums(nxt()))
    log(f"[S1 int4 bench] S1-vpu: column sums equal, total {total.item():.0f}; kernel {ms:.4f} ms "
        f"(kernel alone {alone_ms:.4f} ms, {nbytes / alone_ms / 1e6:.1f} GB/s) plain "
        f"{plain_ms:.4f} ms bound "
        f"{rows['S1-vpu']['bound_ms']:.4f} ms ({rows['S1-vpu']['bound_by']})")
    for key in worst:
        rows[key]["max_abs_err"] = worst[key]
    # v3 computes the same function on the same x and weights
    rows["S1-v3"]["library_ms"] = rows["S1-v4"]["library_ms"]
    return rows


def phase_bench_vit(gen):
    """S2: the bench's attention kernel through both entries at the bench's
    shape, at a 2-frame request's, at two ragged ones and at two that take
    two sweeps (S 300, and 832, the gate); c's time includes its transposes,
    as the bench's does, and its row also carries the kernel alone on rows
    already flat."""
    rows = {}
    for key, fn in (("S2-b", bench_vit.call_b), ("S2-c", bench_vit.call_c)):
        worst = 0.0
        # the first shape has 263 masked keys beside 9 live ones: a lost key mask shows there;
        # the bench's own shape is the one reported in the JSON line
        for b, s, h, d in ((2, 9, 16, 64), (32, 257, 16, 64), (2, 257, 16, 64), (3, 100, 16, 64),
                           (2, 300, 16, 64), (2, 832, 16, 64)):
            q, k, v = (_randn((b, s, h, d), gen) for _ in range(3))
            got = fn(q, k, v)
            sync()
            want = bench_vit.call_plain(q.float(), k.float(), v.float())
            err = (got.float() - want).abs().max().item()
            check(got.shape == want.shape and torch.isfinite(got).all().item(),
                  f"{key}: output finite")
            ms = time_ms(lambda: fn(q, k, v))
            plain_ms = time_ms(lambda: bench_vit.call_plain(q, k, v))
            lib_ms = time_ms(lambda: bench_vit.call_library(q, k, v))
            nbytes, flops = bench_vit.bound(b, s, h, d)
            row = kernel_row(err, ms, plain_ms, nbytes, flops, lib_ms)
            alone = ""
            if key == "S2-c":
                qf, kf, vf = (t.transpose(1, 2).contiguous() for t in (q, k, v))
                row["kernel_alone_ms"] = time_ms(lambda: bench_vit.call_c_flat(qf, kf, vf))
                alone = f" (kernel alone {row['kernel_alone_ms']:.4f} ms)"
            log(f"[S2 vit bench] {key} B={b} S={s} H={h} D={d}: max_abs_err={err:.3e} (tol "
                f"{bench_vit.TOL}) kernel {ms:.4f} ms{alone} ({flops / ms / 1e9:.1f} TFLOP/s) "
                f"plain {plain_ms:.4f} ms scaled_dot_product_attention {lib_ms:.4f} ms bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
            check(err <= bench_vit.TOL, f"{key} error {err} > {bench_vit.TOL}")
            worst = max(worst, err)
            if (b, s) == (bench_vit.B, bench_vit.S):
                rows[key] = row
        rows[key]["max_abs_err"] = worst
    return rows


def phase_bench_run():
    """The three benches in-process, as their users run them: the two kernel
    benches (every variant's count and those of K3b and K5 must rise), then
    the main bench's encode and e2e phases. Returns the kernel benches' counts."""
    counters = {**bench_int4.COUNTERS, **bench_vit.COUNTERS,
                "K3b": int4_mod.LAUNCHES_TILED, "K5": vit_mod.LAUNCHES}
    for counter in counters.values():
        counter.reset()
    _, sec = wall(lambda: (bench_int4.main(quick=True), bench_vit.main()))
    counts = {name: c.count for name, c in counters.items()}
    log(f"[bench] int4_kernel --quick and vit_attention: {sec:.2f} s; kernel launches: "
        + ", ".join(f"{name} {n}" for name, n in counts.items()))
    check(all(n > 0 for n in counts.values()), f"kernel bench launches {counts}")

    results, main_counts = counted(
        "bench main", lambda: bench_main.main(["--phases", "encode", "e2e"]))
    check(all(main_counts[k] > 0 for k in ("K1", "K2", "K5")), f"bench main launches {main_counts}")
    for key in ("encode_frames_per_sec", "xbd_2frame_e2e_latency_s_32newtok"):
        check(np.isfinite(results[key]) and results[key] > 0, f"bench main: {key}")
    return counts


def main():
    phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {"K1": phase_flash(gen), "K2": phase_decode(gen)}
    k3 = phase_int4(gen)
    rows.update({"K3a": k3["k3a"], "K3b": k3["k3b"], "K3c": k3["k3c"],
                 "K3c M<=8": k3["k3c_decode"]})
    rows["K5"] = phase_vit_attention(gen)
    tokenizer = WordTokenizer()

    int4_counts, k3a_counts = phase_int4_path(gen, tokenizer)
    torch.cuda.empty_cache()

    cfg = TEOChatConfig(quant="int8")
    torch.cuda.reset_peak_memory_stats()
    params, init_s = wall(lambda: init_teochat(cfg, gen, "cuda", torch.bfloat16, quant="int8"))
    log(f"[main] init TEOChat-7B int8 (random, seed {SEED}): {init_s:.2f} s, "
        f"allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    model = teochat_mod.TEOChat(cfg, params, tokenizer=tokenizer)
    processor = FrameProcessor(cfg.vision.image_size, SEED)
    (ids, frames), int8_counts = counted(
        "main", lambda: phase_main_path(model, tokenizer, processor))
    check(all(int8_counts[k] > 0 for k in ("K1", "K2", "K5")),
          f"int8 path launches {int8_counts}")
    phase_logits(model, ids, frames)

    k4_rows = phase_flash_backward(gen)
    train_launches = phase_train(cfg, params, tokenizer, processor)
    phase_train_parity(cfg, params, tokenizer, processor, gen)
    del model, params
    torch.cuda.empty_cache()

    s_rows = {**phase_bench_int4(gen), **phase_bench_vit(gen)}
    bench_counts = phase_bench_run()

    def row(name, source, replaces, launches, measured, where="teochat_tpu/ops/"):
        return {"name": name, "route": "cuda", "source": f"teochat_torch/csrc/{source}",
                "replaces": where + replaces, "launches": launches, **measured}

    def bench_row(key, source, replaces):
        name = "bench_" + key.replace("S1-", "int4_").replace("S2-", "vit_attention_")
        return row(name, source, replaces, bench_counts[key], s_rows[key], where="scripts/")

    # launches: K1, K2, K3b, K3c (its prefill's M > 8 kernel and its decode's
    # kernel apart), K5 on the int4 path, K3a on its own request,
    # K4a-c in train(), the benches' variants in their benches; the int8 path's
    # and the main bench's counts are checked above
    kernels = [
        row("flash_attention", "flash_attention.cu", "flash_attention.py:32",
            int4_counts["K1"], rows["K1"]),
        row("decode_attention", "decode_attention.cu", "decode_attention.py:44",
            int4_counts["K2"], rows["K2"]),
        row("flash_attention_fwd_res", "flash_attention.cu", "flash_attention.py:243",
            train_launches["fwd"], k4_rows["fwd"]),
        row("flash_attention_bwd_dkv", "flash_attention_bwd.cu", "flash_attention.py:348",
            train_launches["dkv"], k4_rows["dkv"]),
        row("flash_attention_bwd_dq", "flash_attention_bwd.cu", "flash_attention.py:421",
            train_launches["dq"], k4_rows["dq"]),
        row("int4_matmul", "int4_matmul.cu", "int4_matmul.py:44",
            k3a_counts["K3a"], rows["K3a"]),
        row("int4_matmul_tiled", "int4_matmul.cu", "int4_matmul.py:208",
            int4_counts["K3b"], rows["K3b"]),
        row("int4_matmul_tiled_stacked", "int4_matmul.cu", "int4_matmul.py:348",
            int4_counts["K3c"] - int4_counts["K3c M<=8"], rows["K3c"]),
        row("int4_matmul_tiled_stacked_decode", "int4_matmul.cu", "int4_matmul.py:348",
            int4_counts["K3c M<=8"], rows["K3c M<=8"]),
        row("vit_attention", "vit_attention.cu", "vit_attention.py:42",
            int4_counts["K5"], rows["K5"]),
        bench_row("S1-v2", "bench_int4_kernel.cu", "bench_int4_kernel.py:55"),
        bench_row("S1-v3", "bench_int4_kernel.cu", "bench_int4_kernel.py:135"),
        bench_row("S1-v4", "bench_int4_kernel.cu", "bench_int4_kernel.py:219"),
        bench_row("S1-v5", "bench_int4_kernel.cu", "bench_int4_kernel.py:281"),
        bench_row("S1-vpu", "bench_int4_kernel.cu", "bench_int4_kernel.py:342"),
        bench_row("S1-dma", "bench_int4_kernel.cu", "bench_int4_kernel.py:383"),
        bench_row("S2-b", "bench_vit_attention.cu", "bench_vit_attention.py:36"),
        bench_row("S2-c", "bench_vit_attention.cu", "bench_vit_attention.py:76"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
