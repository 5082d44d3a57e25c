"""Smoke run of the PyTorch / CUDA port (teochat_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; fails (nonzero exit, no result line) without
them. Phases, each printing its lines before the last:

1. device: the card's name and power limit, as nvidia-smi reports them;
2. build: compile the CUDA kernels from teochat_torch/csrc (seconds, and
   ptxas's register / spill report);
3. the flash-attention kernel (K1) against its plain twin at prefill shapes;
4. the decode-attention kernel (K2) against its plain twin at decode shapes;
5. the main path at TEOChat-7B width (ViT-L/14, mlp2x_gelu, LLaMA-7B with
   int8 weights, bf16 activations, random weights from a seed): three
   requests through the unmodified `run_inference_single` and one batched
   generate of four ragged rows; both kernels' launch counts must rise;
6. the last-position prefill logits of the 2-frame request with the kernels
   against the same forward on the plain attention;
7. the training flash attention (K4a forward, K4b dK/dV, K4c dQ) against
   autograd through its plain twin at training shapes, and each kernel's
   time beside the plain forward's and backward's;
8. the training path at TEOChat-7B width: the port's `train()` takes three
   optimizer steps (int8 backbone, LoRA r128 on all seven projections, fp32
   projector, cosine schedule, accumulation 2, remat) on 16 synthetic
   2-frame conversations; the three K4 launch counts must rise;
9. one micro-step's loss and trainable gradients with the kernels against
   the same step on the plain attention.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

from teochat_tpu.config import GenerationConfig, TEOChatConfig
from teochat_tpu.constants import IMAGE_TOKEN_INDEX, OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
from teochat_tpu.eval.inference import run_inference_single
from teochat_tpu.mm_utils import tokenizer_image_token
from teochat_torch.checkpoint.bridge import init_teochat
from teochat_torch.data.dataset import DataArguments, make_supervised_data_module
from teochat_torch.models import fusion as fusion_mod
from teochat_torch.models import llama as llama_mod
from teochat_torch.models import teochat as teochat_mod
from teochat_torch.ops import _build
from teochat_torch.ops import decode_attention as dec_mod
from teochat_torch.ops import flash_attention as flash_mod
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
N_TIMED = 25

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


def sync():
    torch.cuda.synchronize()


def time_ms(fn, n=N_TIMED):
    """Median over n runs, each timed with CUDA events, after one warm-up."""
    fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall(fn):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
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
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"[build] {line.strip()}")


def _randn(shape, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def phase_flash(gen):
    cases = [  # (B, S, H, Hkv, D, causal); the first is reported in the JSON line
        (1, 768, 32, 32, 128, True),  # the 2-frame prompt bucket
        (1, 600, 32, 32, 128, True),  # ragged S
        (1, 768, 32, 8, 128, True),  # GQA
        (4, 768, 32, 32, 128, True),
        (1, 1536, 32, 32, 128, True),  # the 4-frame prompt bucket
        (4, 1536, 32, 32, 128, True),  # the batched generate's prefill
    ]
    worst, main = 0.0, None
    for b, s, h, hkv, d, causal in cases:
        q, k, v = _randn((b, s, h, d), gen), _randn((b, s, hkv, d), gen), _randn((b, s, hkv, d), gen)
        got = flash_mod.flash_attention(q, k, v, causal=causal)
        sync()
        want = flash_mod.flash_attention_plain(q.float(), k.float(), v.float(), causal=causal)
        err = (got.float() - want).abs().max().item()
        check(torch.isfinite(got).all().item(), "flash output finite")
        ms = time_ms(lambda: flash_mod.flash_attention(q, k, v, causal=causal))
        plain_ms = time_ms(lambda: flash_mod.flash_attention_plain(q, k, v, causal=causal))
        flops = 4 * b * h * s * s * d / (2 if causal else 1)
        log(f"[K1 flash] B={b} S={s} H={h} Hkv={hkv} D={d} causal={causal}: "
            f"max_abs_err={err:.3e} (tol {FLASH_TOL}) kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s) plain {plain_ms:.4f} ms")
        check(err <= FLASH_TOL, f"flash error {err} > {FLASH_TOL}")
        worst = max(worst, err)
        if main is None:
            main = (ms, plain_ms)
    return worst, main


def phase_decode(gen):
    ragged = [1025, 1, 517, 1024, 64, 300, 1000, 2]
    cases = [  # (B, H, Hkv, T, lengths), D=128; the first is reported in the JSON line
        (1, 32, 32, 801, [580]),  # 2-frame request: T = 768 + 32 + 1, last step
        (4, 32, 32, 1553, [1100, 1080, 1120, 60]),  # the batched generate's cache
        (1, 32, 32, 1025, [1025]),
        (8, 32, 32, 1025, ragged),
        (1, 32, 8, 1025, [1025]),
        (8, 32, 8, 1025, ragged),
    ]
    worst, main = 0.0, None
    for b, h, hkv, t, lengths in cases:
        d = 128
        # a layer slab of the [L, B, T, Hkv, D] cache, read in place as [B, Hkv, T, D]
        k_slab, v_slab = _randn((b, t, hkv, d), gen), _randn((b, t, hkv, d), gen)
        k, v = k_slab.transpose(1, 2), v_slab.transpose(1, 2)
        q = _randn((b, h, d), gen)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        got = dec_mod.decode_attention(q, k, v, lens)
        sync()
        want = dec_mod.decode_attention_plain(q.float(), k.float(), v.float(), lens)
        err = (got.float() - want).abs().max().item()
        check(torch.isfinite(got).all().item(), "decode output finite")
        ms = time_ms(lambda: dec_mod.decode_attention(q, k, v, lens))
        plain_ms = time_ms(lambda: dec_mod.decode_attention_plain(q, k, v, lens))
        nbytes = 2 * int(lens.sum().item()) * hkv * d * 2
        log(f"[K2 decode] B={b} H={h} Hkv={hkv} D={d} T={t} lengths={lens.tolist()}: "
            f"max_abs_err={err:.3e} (tol {DECODE_TOL}) kernel {ms:.4f} ms "
            f"({nbytes / ms / 1e6:.1f} GB/s of live KV) plain {plain_ms:.4f} ms")
        check(err <= DECODE_TOL, f"decode error {err} > {DECODE_TOL}")
        worst = max(worst, err)
        if main is None:
            main = (ms, plain_ms)
    return worst, main


def phase_main_path(model, tokenizer, processor):
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
        log(f"[main] request {name}: {sec:.3f} s answer={answer[:160]!r}")

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
    _, ttft_s = wall(lambda: model.generate([ids], frames, g1))
    out, full_s = wall(lambda: model.generate([ids], frames, g32))
    steps = len(out[0]) - 1
    log(f"[main] 2-frame bs1: encode {encode_s * 1e3:.2f} ms, TTFT {ttft_s * 1e3:.2f} ms "
        f"(encode + fuse + prefill + first token), decode {steps} steps "
        f"{steps / (full_s - ttft_s):.2f} tok/s ({(full_s - ttft_s) / steps * 1e3:.2f} ms/step)")

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
    log(f"[main] batched generate of 4 ragged rows (prompt lengths "
        f"{[len(r) for r in batch_ids]}): {sec:.3f} s, tokens per row {[len(r) for r in outs]}")
    return ids, frames


def phase_logits(model, ids, frames):
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
        logits[impl] = llama_mod.llama_forward(
            model.params["llm"], cfg.llm, embeds, position_ids=pos, cache=cache,
            write_slots=pos, logits_mode="last", last_index=last, attn_impl=impl,
        )[0, -1]
    a, b = logits["auto"], logits["plain"]
    check(tuple(a.shape) == (cfg.llm.vocab_size,) and torch.isfinite(a).all().item(),
          "logits finite")
    rel = ((a - b).norm() / b.norm()).item()
    log(f"[logits] 2-frame prefill (S={pad_to}, {plan.seq_lens[0]} live) last-position "
        f"logits, kernels vs plain attention: rel L2 {rel:.3e} (bound {LOGITS_REL_L2_BOUND}), "
        f"argmax {int(a.argmax())} vs {int(b.argmax())}")
    check(rel <= LOGITS_REL_L2_BOUND, f"logits rel L2 {rel} > {LOGITS_REL_L2_BOUND}")


def _flash_grads(fn, q, k, v, do):
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    o = fn(q, k, v)
    o.backward(do.to(o.dtype))
    return [x.detach().float() for x in (o, q.grad, k.grad, v.grad)]


def _plain_trainable(q, k, v):
    return flash_mod.flash_attention_plain(q.float(), k.float(), v.float())


def phase_flash_backward(gen):
    cases = [  # (B, S, H, Hkv, padded); D = 128, causal; the first is reported in the JSON line
        (4, 1024, 32, 32, False),  # the training batch
        (1, 600, 32, 32, True),  # ragged S, through the padded wrapper
        (1, 1024, 32, 8, False),  # GQA
        (1, 2048, 32, 32, False),
    ]
    worst = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
    times = None
    for b, s, h, hkv, padded in cases:
        d = 128
        q, k, v = _randn((b, s, h, d), gen), _randn((b, s, hkv, d), gen), _randn((b, s, hkv, d), gen)
        do = _randn((b, s, h, d), gen)
        fn = (flash_mod.flash_attention_trainable_padded if padded
              else flash_mod.flash_attention_trainable)
        got = _flash_grads(fn, q, k, v, do)
        sync()
        want = _flash_grads(_plain_trainable, q, k, v, do)
        errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
        check(all(torch.isfinite(g).all().item() for g in got), "flash backward finite")
        check(errs[0] <= FLASH_TOL, f"K4a output error {errs[0]} > {FLASH_TOL}")
        rel = []
        for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
            r2 = ((g - w).norm() / w.norm()).item()
            rmax = (g - w).abs().max().item() / w.abs().max().item()
            rel.append(f"{name} rel L2 {r2:.3e} rel max {rmax:.3e}")
            check(r2 <= GRAD_REL_L2 and rmax <= GRAD_REL_MAX,
                  f"{name}: rel L2 {r2} (bound {GRAD_REL_L2}), rel max {rmax} (bound {GRAD_REL_MAX})")
        worst["fwd"] = max(worst["fwd"], errs[0])
        worst["dq"] = max(worst["dq"], errs[1])
        worst["dkv"] = max(worst["dkv"], errs[2], errs[3])
        log(f"[K4 flash train] B={b} S={s} H={h} Hkv={hkv} D={d} padded={padded}: o max_abs_err "
            f"{errs[0]:.3e}; dq/dk/dv max_abs_err {errs[1]:.3e}/{errs[2]:.3e}/{errs[3]:.3e}; "
            + "; ".join(rel))
        if times is None:
            times = _time_flash_backward(q, k, v, do)
    return worst, times


def _time_flash_backward(q, k, v, do):
    """Each K4 kernel alone (the backward ones from saved residuals), and the
    plain forward and backward, at one shape."""
    b, s, h, d = q.shape
    scale = d ** -0.5
    o, m, l = flash_mod._fwd_res_cuda(q, k, v, True, scale)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    t = {
        "fwd": time_ms(lambda: flash_mod._fwd_res_cuda(q, k, v, True, scale)),
        "dkv": time_ms(lambda: flash_mod._bwd_dkv_cuda(q, k, v, do, m, l, di, True, scale)),
        "dq": time_ms(lambda: flash_mod._bwd_dq_cuda(q, k, v, do, m, l, di, True, scale)),
        "plain_fwd": time_ms(lambda: flash_mod.flash_attention_plain(q, k, v)),
    }
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    op = flash_mod.flash_attention_plain(qg, kg, vg)
    t["plain_bwd"] = time_ms(lambda: torch.autograd.grad(op, (qg, kg, vg), do, retain_graph=True))
    product = 2 * b * h * s * s * d / 2  # one causal S x S x D product
    log(f"[K4 flash train] B={b} S={s} H={h} D={d} times: K4a {t['fwd']:.4f} ms "
        f"({2 * product / t['fwd'] / 1e9:.1f} TFLOP/s), K4b {t['dkv']:.4f} ms "
        f"({4 * product / t['dkv'] / 1e9:.1f} TFLOP/s), K4c {t['dq']:.4f} ms "
        f"({3 * product / t['dq'] / 1e9:.1f} TFLOP/s); plain forward {t['plain_fwd']:.4f} ms, "
        f"plain backward {t['plain_bwd']:.4f} ms")
    return t


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


def main():
    phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flash_err, flash_ms = phase_flash(gen)
    dec_err, dec_ms = phase_decode(gen)

    cfg = TEOChatConfig(quant="int8")
    torch.cuda.reset_peak_memory_stats()
    params, init_s = wall(lambda: init_teochat(cfg, gen, "cuda", torch.bfloat16, quant="int8"))
    log(f"[main] init TEOChat-7B int8 (random, seed {SEED}): {init_s:.2f} s, "
        f"allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    tokenizer = WordTokenizer()
    model = teochat_mod.TEOChat(cfg, params, tokenizer=tokenizer)
    processor = FrameProcessor(cfg.vision.image_size, SEED)

    flash_mod.LAUNCHES.reset()
    dec_mod.LAUNCHES.reset()
    ids, frames = phase_main_path(model, tokenizer, processor)
    launches = {"flash": flash_mod.LAUNCHES.count, "decode": dec_mod.LAUNCHES.count}
    log(f"[main] kernel launches during the main path: K1 flash {launches['flash']}, "
        f"K2 decode {launches['decode']}; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    check(launches["flash"] > 0 and launches["decode"] > 0, "both kernels ran on the main path")

    phase_logits(model, ids, frames)

    k4_err, k4_ms = phase_flash_backward(gen)
    train_launches = phase_train(cfg, params, tokenizer, processor)
    phase_train_parity(cfg, params, tokenizer, processor, gen)

    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "teochat_torch/csrc/flash_attention.cu",
         "replaces": "teochat_tpu/ops/flash_attention.py:32",
         "launches": launches["flash"], "max_abs_err": flash_err,
         "ms": flash_ms[0], "plain_ms": flash_ms[1]},
        {"name": "decode_attention", "route": "cuda",
         "source": "teochat_torch/csrc/decode_attention.cu",
         "replaces": "teochat_tpu/ops/decode_attention.py:44",
         "launches": launches["decode"], "max_abs_err": dec_err,
         "ms": dec_ms[0], "plain_ms": dec_ms[1]},
        {"name": "flash_attention_fwd_res", "route": "cuda",
         "source": "teochat_torch/csrc/flash_attention.cu",
         "replaces": "teochat_tpu/ops/flash_attention.py:243",
         "launches": train_launches["fwd"], "max_abs_err": k4_err["fwd"],
         "ms": k4_ms["fwd"], "plain_ms": k4_ms["plain_fwd"]},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": "teochat_torch/csrc/flash_attention_bwd.cu",
         "replaces": "teochat_tpu/ops/flash_attention.py:348",
         "launches": train_launches["dkv"], "max_abs_err": k4_err["dkv"],
         "ms": k4_ms["dkv"], "plain_ms": k4_ms["plain_bwd"]},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": "teochat_torch/csrc/flash_attention_bwd.cu",
         "replaces": "teochat_tpu/ops/flash_attention.py:421",
         "launches": train_launches["dq"], "max_abs_err": k4_err["dq"],
         "ms": k4_ms["dq"], "plain_ms": k4_ms["plain_bwd"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
