"""Benchmark of the port's main paths on one NVIDIA card.

Port of the phases of bench.py whose modules the port has. Each prints what
its JAX twin returns, under the same key where the quantity is the same, on
`TEOChatConfig()` at full width and depth (ViT-L/14 @ 224 px in bf16;
LLaMA-7B, int8 or int4 weight-only) with random weights from a seed:

- encode: `encode_frames_per_sec` (a batch of 32 frames through the tower
  and the projector);
- encode_w8a8: `encode_frames_per_sec_w8a8`, the same batch through the
  w8a8 tower (`quantize_vit_params`' layout: per-token int8 activations on
  the int8 tensor cores);
- decode: `decode_tokens_per_sec` (+ `_min` / `_max` over the timed batches),
  `ttft_s_prefill640_int8`, `prefill_tokens`, `hbm_stream_peak_gbps` and the
  roofline keys `decode_effective_hbm_gbps`, `decode_pct_of_hbm_peak`;
- ttft_int8act: `ttft_s_prefill640_int8act`, decode's prefill + first token
  with `int8_prefill_activations` (the prefill's int8 projections w8a8,
  the decode step w8a16);
- decode_bs8 / decode_bs16: `decode_tokens_per_sec_bs8` / `_bs16`;
- decode_bs32: `decode_tokens_per_sec_bs32_fp8kv` (int8, an e4m3 KV cache:
  bf16's would take 11.8 GB);
- decode_int4: `decode_tokens_per_sec_int4` and its `_int4` roofline keys,
  then `decode_tokens_per_sec_int4_fp8kv` (the same with an e4m3 cache);
- decode_spec: greedy decode with prompt-lookup speculation (k = 8) at batch
  1: `decode_tokens_per_sec_spec_bs1`, `spec_iteration_s`, steps and tokens
  a step; on the `_SPEC_WORKLOADS` (an oracle forces the target to a real
  TEOChat answer) `decode_tokens_per_sec_spec_{w}`, `spec_acceptance_{w}`,
  `spec_tokens_per_step_{w}`; with drafts corrupted to keep rates 0.75 /
  0.5 / 0.25 `decode_tokens_per_sec_spec_bs1_acc{pct}` and
  `spec_tokens_per_step_acc{pct}`;
- ttft_turn2: `ttft_s_turn2_suffix64_over640` (a 64-token suffix prefilled
  over a session cache holding 640 committed tokens, K2m over the cache);
- e2e: `xbd_2frame_e2e_latency_s_32newtok` (encode 2 frames + prefill 640
  fused tokens + 32 new tokens);
- serve: 8 concurrent greedy requests of 121 text tokens and 64 new tokens
  through the continuous-batching engine (serve/engine.py; max_slots 8,
  max_len 512, chunk 16), the median of 3 runs:
  `serve_aggregate_tokens_per_sec_8streams`, `serve_8x64tok_wall_s`,
  `serve_max_concurrent`;
- ttft_prefix: a 1-token request's time through the engine (queue, prefill,
  first-token read) with a 512-token text prefix pooled (a hit: row copy and
  suffix prefill) and not (a miss): `ttft_s_prefix_miss_515tok`,
  `ttft_s_prefix_hit_515tok`, `prefix_hit_ttft_speedup`,
  `prefix_tokens_saved`;
- ttft_prefix_curve: the same at prefixes of 128, 1024 and 2048 tokens:
  `ttft_s_prefix_{miss,hit}_{plen}tok`, `prefix_hit_ttft_speedup_{plen}`;
- train: `train_tokens_per_sec`, `train_mfu` (LoRA r128 over the int8
  backbone, batch 2 x 640 tokens, remat) against `tensor_core_peak_tflops`,
  then at the recipe's accumulation of 8 micro-batches an optimizer step
  `train_tokens_per_sec_accum8`, `train_mfu_accum8`;
- train_bf16: full fine-tuning (every leaf but the tower's, fp32 masters)
  of a bf16 TinyLlama-1.1B-geometry decoder (h 2048, i 5632, 22 layers, 32
  heads, 4 kv heads) under the ViT-L/14 tower, batch 2 x 640, remat:
  `train_tokens_per_sec_bf16full_1b`, `train_mfu_bf16full_1b` (7B full
  fine-tuning needs ~112 GB of fp32 masters and moments);
- eval: 16 synthetic 2-frame xBD-style examples (512 x 640 uint8 frames, 16
  new tokens) through `run_inference_batched` at batch 8 and at batch 1:
  `eval_examples_per_sec_bs8`, `_bs1`, `eval_bs8_vs_bs1`;
- preprocess (the host alone): 64 frames of 512 x 640 through the PIL path
  and the native one: `preprocess_pil_frames_per_sec`,
  `preprocess_native_frames_per_sec`;
- encode_pipeline: 8 batches of 32 raw 512 x 640 frames to vision tokens on
  the bf16 tower, host-native preprocessing on a worker thread beside the
  device encode (`encode_sustained_fps_hostpre`) and `preprocess_frames` on
  the card (`encode_sustained_fps_devicepre`), beside the encode of frames
  already on the card (`encode_frames_per_sec_deviceonly`,
  `encode_sustained_vs_deviceonly`) and the upload rate of one batch of
  uint8 frames (`h2d_mbps`); the same four again on the w8a8 tower
  (bench.py's), each key ending `_w8a8`.

The two peaks are measured on this card, not read from a data sheet: the
stream peak by tall-skinny `torch.matmul`s over eight distinct 512 MB bf16
panels (the pattern decode is bound by), the tensor-core peak by four chained
8192^3 bf16 products. Every phase of bench.py is ported (bench.py's path C
key of encode_pipeline aside). Times are host wall times around work that
ends in a synchronize.

Run: python3 -m teochat_torch.bench.main [--phases encode decode ...]
The last line is one JSON object of every key.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional

import numpy as np
import torch

from teochat_torch.bench import _timing
from teochat_torch.checkpoint import bridge
from teochat_torch.config import GenerationConfig, TEOChatConfig
from teochat_torch.constants import IMAGE_TOKEN_INDEX
from teochat_torch.data.processing import ImageProcessor
from teochat_torch.eval.inference import run_inference_batched
from teochat_torch.models import fusion as fusion_mod
from teochat_torch.models import generation as gen_mod
from teochat_torch.models import llama as llama_mod
from teochat_torch.models import teochat as teochat_mod
from teochat_torch.ops.preprocess import preprocess_frames
from teochat_torch.serve.engine import BatchEngine
from teochat_torch.train import lora as lora_mod
from teochat_torch.train import trainer as trainer_mod
from teochat_torch.utils import resolve_device


@dataclasses.dataclass
class Settings:
    """What the phases run on; the defaults are the published widths and bench.py's shapes."""

    cfg: TEOChatConfig = dataclasses.field(default_factory=TEOChatConfig)
    device: Optional[str] = None  # None = the card
    seed: int = 0
    prompt_len: int = 640  # fused prompt: 2 frames and `text_tokens` + 3 text tokens, padded
    text_tokens: int = 123
    decode_new: int = 64
    spec_k: int = 8
    turn2_suffix: int = 64  # ttft_turn2: text tokens after the committed prompt_len
    turn2_pad: int = 128
    turn2_max_len: int = 1024
    e2e_new: int = 32
    serve_requests: int = 8  # serve: concurrent requests of 1 + serve_text tokens
    serve_text: int = 120
    serve_new: int = 64
    serve_max_len: int = 512
    serve_chunk: int = 16
    prefix_len: int = 512  # ttft_prefix: the shared run, BOS included; 3 tokens follow
    prefix_max_len: int = 1024
    prefix_min_tokens: int = 32
    prefix_curve: tuple = ((128, 512), (1024, 2048), (2048, 2560))  # (prefix, max_len)
    enc_batch: int = 32
    enc_iters: int = 20
    frame_hw: tuple = (512, 640)  # eval, preprocess, encode_pipeline: raw uint8 frames
    eval_examples: int = 16
    eval_batch: int = 8
    eval_new: int = 16
    preprocess_n: int = 64  # preprocess: frames a timed call
    pipeline_batches: int = 8  # encode_pipeline: batches of enc_batch frames
    train_batch: int = 2
    # train_bf16's decoder geometry (TinyLlama-1.1B), over cfg.llm
    train_bf16_llm: dict = dataclasses.field(default_factory=lambda: dict(
        hidden_size=2048, intermediate_size=5632, num_layers=22, num_heads=32, num_kv_heads=4))
    iters: int = 3
    stream_side: int = 16384  # the stream probe's panels are [side, side] bf16
    stream_panels: int = 8
    stream_reps: int = 6
    matmul_side: int = 8192

    @property
    def dev(self) -> torch.device:
        return resolve_device(self.device)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    @property
    def tokens_per_frame(self) -> int:
        n = self.cfg.vision.num_patches
        return n if self.cfg.mm_vision_select_feature == "patch" else n + 1

    def generator(self, offset: int = 0) -> torch.Generator:
        return torch.Generator(device=self.dev).manual_seed(self.seed + offset)

    def prompt_ids(self, batch: int):
        """bench.py's 2-frame prompt: BOS, two image sentinels, the text tokens."""
        return [[1] + [IMAGE_TOKEN_INDEX, 7] * 2 + list(range(10, 10 + self.text_tokens))] * batch

    def frames(self, n: int) -> torch.Tensor:
        size = self.cfg.vision.image_size
        rgb = np.random.RandomState(0).randn(n, 3, size, size).astype(np.float32)
        return torch.from_numpy(rgb).to(self.dev, self.dtype)


def _never_stop() -> gen_mod.StopSpec:
    return gen_mod.StopSpec(keyword_ids=np.zeros((1, 1), np.int32),
                            keyword_lens=np.zeros((1,), np.int32), eos_id=-1)


def _tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for _, x in trainer_mod.tree_leaves_with_path(tree))


# ------------------------------------------------------------- the two peaks

def measure_stream_peak_gbps(st: Settings) -> float:
    """Achievable weight-streaming bandwidth on this card, the pattern decode is
    bound by: tall-skinny products that each read a fresh [side, side] bf16
    panel (eight distinct 512 MB panels at the default size, far past the L2),
    chained through a data dependence; GB/s of panel bytes over the wall time."""
    n, k, dev = st.stream_side, st.stream_panels, st.dev
    ws = [torch.full((n, n), 1e-4, dtype=torch.bfloat16, device=dev) for _ in range(k)]
    x0 = torch.ones((8, n), dtype=torch.bfloat16, device=dev)

    def chain():
        x, acc = x0, torch.zeros((8, n), dtype=torch.float32, device=dev)
        for _ in range(st.stream_reps):
            for w in ws:
                acc = acc + torch.matmul(x, w).float()
            x = x + (acc[:, :1] * 1e-12).to(torch.bfloat16)
        return acc

    dt = _timing.timeit(chain, iters=1, device=dev)
    return st.stream_reps * k * 2 * n * n / dt / 1e9


def measure_tensor_core_peak_tflops(st: Settings) -> float:
    """Achievable bf16 matmul rate on this card: four chained side^3 products.
    The MFU denominator: measured, not a data sheet's."""
    n, dev = st.matmul_side, st.dev
    x = torch.ones((n, n), dtype=torch.bfloat16, device=dev)
    w = torch.full((n, n), 1e-4, dtype=torch.bfloat16, device=dev)

    def chain():
        y = x
        for _ in range(4):
            y = torch.matmul(y, w)
        return y

    dt = _timing.timeit(chain, iters=3, device=dev)
    return 4 * 2 * n ** 3 / dt / 1e12


# ------------------------------------------------------------------ arithmetic

def _roofline_keys(tok_s: float, weight_bytes: int, kv_bytes: float,
                   peak_gbps: float, tag: str = "") -> dict:
    """Effective device-memory GB/s of a measured decode rate against the
    card's measured stream peak. bytes/step = every weight byte once + the
    KV bytes a step reads."""
    eff = tok_s * (weight_bytes + kv_bytes) / 1e9
    return {
        f"decode_effective_hbm_gbps{tag}": eff,
        f"decode_pct_of_hbm_peak{tag}": eff / peak_gbps if peak_gbps else None,
    }


def _llm_matmul_params(cfg) -> int:
    """Backbone matmul params (per-token FLOPs = 2x this in a forward):
    q/k/v/o + gate/up/down per layer + the lm_head."""
    h, i = cfg.hidden_size, cfg.intermediate_size
    kvh = cfg.num_kv_heads * cfg.head_dim
    per_layer = h * h * 2 + h * kvh * 2 + 3 * h * i
    return cfg.num_layers * per_layer + cfg.vocab_size * h


def _train_mfu(cfg, tok_s: float, seq: int, peak_tflops: float, full_finetune: bool) -> float:
    """Model-FLOPs utilization (useful FLOPs only: remat's recompute is not
    credited). Per token: forward 2P; backward 4P when weight gradients are
    computed (full fine-tuning) or 2P when only activation gradients flow
    through the frozen backbone (LoRA). Attention adds 12 L h T_avg (scores and
    context, forward and backward), in both modes."""
    p = _llm_matmul_params(cfg)
    factor = 6 if full_finetune else 4
    att = 12 * cfg.num_layers * cfg.num_heads * cfg.head_dim * (seq / 2)
    return tok_s * (factor * p + att) / (peak_tflops * 1e12)


# --------------------------------------------------------------------- phases

def build_decode_setup(st: Settings, batch: int = 1, quant: str = "int8",
                       kv_dtype: Optional[str] = None, int8_act: bool = False):
    """(run_generate, max_new, prompt_len): `run_generate(n_new)` prefills the
    2-frame prompt of `batch` rows on stand-in fused embeddings and decodes
    greedily without ever stopping (or at the stops of `stops`, a StopSpec,
    where one is given), over a KV cache in `kv_dtype` (None: the model's);
    it carries `weight_bytes` (every leaf of the decoder) and `kv_bytes`
    (the live KV bytes a decode step reads at the cache's itemsize, mean
    over the steps: the decode kernel reads each row up to its length).
    `int8_act` runs the prefill's int8 projections w8a8."""
    cfg, dev = st.cfg, st.dev
    if int8_act:
        cfg = dataclasses.replace(
            cfg, llm=dataclasses.replace(cfg.llm, int8_prefill_activations=True))
    llm = bridge.init_llama(cfg.llm, st.generator(), dev, st.dtype, quant=quant)
    prompt_len, max_new = st.prompt_len, st.decode_new
    t_max = prompt_len + max_new + 1
    plan = fusion_mod.build_fusion_plan(
        st.prompt_ids(batch), tokens_per_frame=st.tokens_per_frame, pad_to=prompt_len)
    embeds = torch.from_numpy(
        (np.random.RandomState(1).randn(batch, prompt_len, cfg.llm.hidden_size) * 0.02)
        .astype(np.float32)).to(dev, st.dtype)
    seq_lens, mask, pos = (torch.as_tensor(a, device=dev)
                           for a in (plan.seq_lens, plan.attention_mask, plan.position_ids))
    stop, gen = _never_stop(), st.generator()
    cache_dtype = llama_mod.kv_dtype_of(kv_dtype, st.dtype)

    def run_generate(n_new: int, stops: Optional[gen_mod.StopSpec] = None):
        return gen_mod.generate_tokens(
            llm, cfg.llm, embeds, seq_lens, mask, pos, stops or stop, gen,
            max_new_tokens=n_new, temperature=0.0, do_sample=False, cache_len=t_max,
            kv_dtype=cache_dtype)[0]

    run_generate.weight_bytes = _tree_bytes(llm)
    mean_live = float(plan.seq_lens.sum()) + batch * (max_new - 1) / 2
    run_generate.kv_bytes = (2 * cfg.llm.num_layers * mean_live * cfg.llm.num_kv_heads
                             * cfg.llm.head_dim * cache_dtype.itemsize)
    return run_generate, max_new, prompt_len


def _decode_times(st: Settings, batch: int, quant: str, kv_dtype: Optional[str] = None):
    """(sorted full-loop times, the least prefill + 1 token time, the
    setup). Both terms are batches of repeated runs, taken in turn, and a
    rate takes the least of each: a stall lengthens a batch and never
    shortens one, so the least is the run's own time, where the median of
    the prefill runs could exceed the fastest full loop and make the
    difference negative. The decode graphs are dropped after (each keeps a
    KV cache alive)."""
    run_generate, max_new, prompt_len = build_decode_setup(st, batch, quant, kv_dtype)
    t_fulls, t_ones = _timing.timeit_interleaved(
        [lambda: run_generate(max_new), lambda: run_generate(1)], st.iters, st.dev)
    t_one = t_ones[0]
    gen_mod.clear_decode_graphs()
    return t_fulls, t_one, run_generate, max_new, prompt_len


def _encode_s(st: Settings, vision_quant: Optional[str] = None) -> float:
    """Seconds a batch of `enc_batch` frames takes through the tower (w8a8
    with vision_quant='int8') and the projector."""
    params = bridge.init_encoder(st.cfg, st.generator(), st.dev, st.dtype,
                                 vision_quant=vision_quant)
    frames = st.frames(st.enc_batch)
    with torch.no_grad():
        return _timing.timeit(lambda: teochat_mod.encode_frames(params, st.cfg, frames),
                              st.enc_iters, st.dev)


def phase_encode(st: Settings) -> dict:
    dt = _encode_s(st)
    return {"encode_s_per_batch": dt, "encode_frames_per_sec": st.enc_batch / dt}


def phase_encode_w8a8(st: Settings) -> dict:
    """The encode phase's batch through the w8a8 tower (bench.py's opt-in:
    close to the bf16 tower, not equal to it)."""
    dt = _encode_s(st, "int8")
    return {"encode_s_per_batch_w8a8": dt, "encode_frames_per_sec_w8a8": st.enc_batch / dt}


def phase_decode(st: Settings) -> dict:
    with torch.no_grad():
        t_fulls, t_one, run_generate, max_new, prompt_len = _decode_times(st, 1, "int8")
    # the headline from the least of each term; the spread from each
    # full-loop batch against the least prefill
    tok_s = sorted((max_new - 1) / (t - t_one) for t in t_fulls)
    peak = measure_stream_peak_gbps(st)
    return {
        "decode_tokens_per_sec": tok_s[-1],
        "decode_tokens_per_sec_min": tok_s[0],
        "decode_tokens_per_sec_max": tok_s[-1],
        "ttft_s_prefill640_int8": t_one,
        "full_loop_s": t_fulls[0],
        "prefill_tokens": prompt_len,
        "hbm_stream_peak_gbps": peak,
        **_roofline_keys(tok_s[-1], run_generate.weight_bytes, run_generate.kv_bytes, peak),
    }


def phase_ttft_int8act(st: Settings) -> dict:
    """decode's prefill + first token with the prefill's int8 projections
    w8a8 (per-token int8 activations on the int8 tensor cores; the decode
    steps stay w8a16)."""
    with torch.no_grad():
        run_generate, _, _ = build_decode_setup(st, 1, "int8", int8_act=True)
        t_one = _timing.timeit(lambda: run_generate(1), st.iters, st.dev)
    gen_mod.clear_decode_graphs()
    return {"ttft_s_prefill640_int8act": t_one}


def _phase_decode_batched(st: Settings, batch: int, kv_dtype: Optional[str] = None,
                          tag: str = "") -> dict:
    """Serving throughput: `batch` concurrent sequences share each weight read."""
    with torch.no_grad():
        t_fulls, t_one, _, max_new, _ = _decode_times(st, batch, "int8", kv_dtype)
    return {f"decode_tokens_per_sec_bs{batch}{tag}":
            batch * (max_new - 1) / (t_fulls[0] - t_one)}


def phase_decode_bs8(st: Settings) -> dict:
    return _phase_decode_batched(st, 8)


def phase_decode_bs16(st: Settings) -> dict:
    return _phase_decode_batched(st, 16)


def phase_decode_bs32(st: Settings) -> dict:
    """Batch 32 with an e4m3 KV cache (bench.py's: a bf16 one would take
    11.8 GB beside the 6.6 GB of int8 weights)."""
    return _phase_decode_batched(st, 32, kv_dtype="float8_e4m3fn", tag="_fp8kv")


def phase_decode_int4(st: Settings) -> dict:
    """Batch-1 decode with packed int4 weights (w4a16) and a bf16 KV cache,
    then the same with an e4m3 one (the KV's share of a step's bytes grows
    once the weights are int4)."""
    out = {}
    for kv_dtype, key in ((None, "decode_tokens_per_sec_int4"),
                          ("float8_e4m3fn", "decode_tokens_per_sec_int4_fp8kv")):
        with torch.no_grad():
            t_fulls, t_one, run_generate, max_new, _ = _decode_times(st, 1, "int4", kv_dtype)
        out[key] = (max_new - 1) / (t_fulls[0] - t_one)
        if kv_dtype is None:
            peak = measure_stream_peak_gbps(st)
            out.update(_roofline_keys(out[key], run_generate.weight_bytes,
                                      run_generate.kv_bytes, peak, tag="_int4"))
    return out


def _eo_tokenize(text, table):
    """Deterministic LLaMA-like tokenization for the bench's workloads
    (bench.py's): digits one token each, punctuation single, words whole
    pieces with their leading space. Prompt-lookup acceptance depends only
    on the sequence's n-gram self-similarity, which this keeps; `table` maps
    piece -> id across calls, so prompt and answer share ids."""
    ids = []
    for piece in re.findall(r" ?[A-Za-z_-]+| ?\d| ?[^A-Za-z\d ]", text):
        if piece not in table:
            table[piece] = 100 + len(table)
        ids.append(table[piece])
    return ids


# bench.py's TEOChat answer workloads, (prompt, answer): change detection's
# bbox list (fresh coordinates, structure repeats: low acceptance) and
# region QA, whose answer echoes the prompt's boxes and class names (high
# acceptance). An oracle forces the greedy target to the answer.
_SPEC_WORKLOADS = {
    "detection": (
        "This is a sequence of two satellite images. Identify all buildings"
        " that were constructed between image 1 and image 2. Output the"
        " bounding box of each new building.",
        "[[306, 283, 338, 308], [312, 290, 341, 315], [118, 206, 141, 227],"
        " [123, 212, 147, 231], [305, 117, 331, 139]]",
    ),
    "regionqa": (
        "Here are two satellite images. What is the damage level of the"
        " building at [306, 283, 338, 308] and of the building at"
        " [118, 206, 141, 227]? Choose from: no-damage, minor-damage,"
        " major-damage, destroyed. Answer with each bounding box followed"
        " by its damage level.",
        "The building at [306, 283, 338, 308] is classified as minor-damage."
        " The building at [118, 206, 141, 227] is classified as no-damage."
        " Overall, the area around [306, 283, 338, 308] shows minor-damage"
        " to several structures.",
    ),
}


def build_spec_setup(st: Settings):
    """`run(n_new, keep_prob=None, workload=None)`: bench.py's decode_spec
    request at batch 1 (the 2-frame prompt of `prompt_len` fused tokens on
    stand-in embeddings, `spec_k` drafts, greedy, never stopping) through
    `generate_tokens_spec`; `workload` names one of `_SPEC_WORKLOADS`, whose
    prompt ids seed the history and whose answer is the oracle. Each call
    draws from a generator seeded alike (the corruption of a keep rate is
    the same every call). Returns (tokens, steps, accepted)."""
    cfg, dev = st.cfg, st.dev
    llm = bridge.init_llama(cfg.llm, st.generator(), dev, st.dtype, quant="int8")
    prompt_len, max_new, spec_k = st.prompt_len, st.decode_new, st.spec_k
    embeds = torch.from_numpy(
        (np.random.RandomState(1).randn(1, prompt_len, cfg.llm.hidden_size) * 0.02)
        .astype(np.float32)).to(dev, st.dtype)
    stop = _never_stop()
    (base,) = st.prompt_ids(1)
    width = len(base)

    def row(ids, oracle=None):
        plan = fusion_mod.build_fusion_plan([ids], tokens_per_frame=st.tokens_per_frame,
                                            pad_to=prompt_len)
        pids = np.full((1, width), -1, np.int32)
        pids[0, :len(ids)] = ids
        return (tuple(torch.as_tensor(a, device=dev)
                      for a in (plan.seq_lens, plan.attention_mask, plan.position_ids)),
                pids, np.asarray([len(ids)], np.int32), oracle)

    rows, table = {None: row(base)}, {}
    for name, (ptext, rtext) in _SPEC_WORKLOADS.items():
        ptoks = _eo_tokenize(ptext, table)[:st.text_tokens]
        rtoks = _eo_tokenize(rtext, table)
        assert len(rtoks) >= max_new, (name, len(rtoks))
        rows[name] = row([1] + [IMAGE_TOKEN_INDEX, 7] * 2 + ptoks,
                         np.asarray([rtoks[:max_new]], np.int32))

    def run(n_new: int, keep_prob=None, workload=None):
        (seq_lens, mask, pos), pids, plen, oracle = rows[workload]
        return gen_mod.generate_tokens_spec(
            llm, cfg.llm, embeds, seq_lens, mask, pos, pids, plen, stop, st.generator(),
            max_new_tokens=n_new, cache_len=prompt_len + n_new + spec_k + 1, spec_k=spec_k,
            draft_keep_prob=keep_prob, oracle_ids=None if oracle is None else oracle[:, :n_new])

    return run


def phase_decode_spec(st: Settings) -> dict:
    """Batch-1 greedy decode with prompt-lookup speculation (spec_k drafts a
    verify iteration). Decode streams the weights, so a (k + 1)-token verify
    iteration costs about one plain step, and tokens/s multiply by the
    tokens an iteration records. The workloads' numbers (an oracle forces a
    real answer's shape, the acceptance is measured) come first; the
    synthetic run and the forced-acceptance curve are kept as references."""
    max_new, spec_k = st.decode_new, st.spec_k
    with torch.no_grad():
        run = build_spec_setup(st)
        last = {}

        def timed(**kw):
            def fn():
                tokens, _, steps, accepted = run(max_new, **kw)
                last["stats"] = (steps, accepted)
                return tokens
            t = _timing.timeit_all(fn, st.iters, st.dev)[0]
            return t, *(int(x) for x in last["stats"])

        # each rate from the least of each term's runs, as _decode_times takes them
        t_full, steps, _ = timed()
        t_one = _timing.timeit_all(lambda: run(1)[0], st.iters, st.dev)[0]
        results = {
            "decode_tokens_per_sec_spec_bs1": (max_new - 1) / (t_full - t_one),
            "spec_iteration_s": (t_full - t_one) / max(steps - 1, 1),
            f"spec_steps_for_{max_new}_tokens": steps,
            "spec_mean_tokens_per_step": max_new / max(steps, 1),
        }
        # the workloads: one prefill + first token costs the same for all, so
        # t_one is their baseline
        for name in _SPEC_WORKLOADS:
            t_w, steps_w, acc_w = timed(workload=name)
            results[f"decode_tokens_per_sec_spec_{name}"] = (max_new - 1) / (t_w - t_one)
            results[f"spec_acceptance_{name}"] = acc_w / max(steps_w * spec_k, 1)
            results[f"spec_tokens_per_step_{name}"] = max_new / max(steps_w, 1)
        # tok/s against a forced acceptance rate: the keep probability is a
        # device scalar of the loop's state, so the three rates share one graph
        for rate in (0.75, 0.5, 0.25):
            t_r, steps_r, _ = timed(keep_prob=rate)
            pct = int(rate * 100)
            results[f"decode_tokens_per_sec_spec_bs1_acc{pct}"] = (max_new - 1) / (t_r - t_one)
            results[f"spec_tokens_per_step_acc{pct}"] = max_new / max(steps_r, 1)
    return results


def phase_ttft_turn2(st: Settings) -> dict:
    """Multi-turn TTFT: with `prompt_len` tokens committed in a session cache,
    the next turn prefills only its `turn2_suffix` tokens (padded to
    `turn2_pad`; K2m over the committed cache) instead of the whole
    conversation: the suffix prefill + its last logits."""
    cfg, dev = st.cfg, st.dev
    committed, suffix, pad = st.prompt_len, st.turn2_suffix, st.turn2_pad
    hidden = cfg.llm.hidden_size
    with torch.no_grad():
        llm = bridge.init_llama(cfg.llm, st.generator(), dev, st.dtype, quant="int8")
        cache = llama_mod.init_cache(cfg.llm, 1, st.turn2_max_len, dtype=st.dtype, device=dev)
        emb1 = torch.from_numpy((np.random.RandomState(0).randn(1, committed, hidden) * 0.02)
                                .astype(np.float32)).to(dev, st.dtype)
        ar = torch.arange(committed, device=dev)[None]
        gen_mod.prefill_full(llm, cfg.llm, cache, emb1, torch.full((1,), committed, device=dev),
                             torch.ones((1, committed), dtype=torch.bool, device=dev), ar)
        plan = fusion_mod.build_fusion_plan([list(range(10, 10 + suffix))],
                                            tokens_per_frame=st.tokens_per_frame, pad_to=pad)
        emb2 = torch.from_numpy((np.random.RandomState(1).randn(1, pad, hidden) * 0.02)
                                .astype(np.float32)).to(dev, st.dtype)
        start = torch.full((1,), committed, device=dev)
        seq_lens, mask, pos = (torch.as_tensor(a, device=dev)
                               for a in (plan.seq_lens, plan.attention_mask, plan.position_ids))
        dt = _timing.timeit(lambda: gen_mod.prefill_suffix(llm, cfg.llm, cache, emb2, start,
                                                           seq_lens, mask, pos)[0],
                            5, dev)
    return {f"ttft_s_turn2_suffix{suffix}_over{committed}": dt}


def phase_e2e(st: Settings) -> dict:
    """2-frame encode + prefill + 32 new tokens, one process: end-to-end latency."""
    cfg, dev = st.cfg, st.dev
    params = bridge.init_teochat(cfg, st.generator(), dev, st.dtype, quant="int8")
    prompt_len, max_new = st.prompt_len, st.e2e_new
    plan = fusion_mod.build_fusion_plan(
        st.prompt_ids(1), tokens_per_frame=st.tokens_per_frame, pad_to=prompt_len)
    frames = st.frames(2)
    seq_lens, mask, pos = (torch.as_tensor(a, device=dev)
                           for a in (plan.seq_lens, plan.attention_mask, plan.position_ids))
    stop, gen = _never_stop(), st.generator()

    def fn():
        vt = teochat_mod.encode_frames(params, cfg, frames)
        emb = teochat_mod.multimodal_embeds(params, cfg, plan, vt)
        return gen_mod.generate_tokens(
            params["llm"], cfg.llm, emb, seq_lens, mask, pos, stop, gen,
            max_new_tokens=max_new, temperature=0.0, do_sample=False,
            cache_len=prompt_len + max_new + 1)[0]

    with torch.no_grad():
        return {"xbd_2frame_e2e_latency_s_32newtok": _timing.timeit(fn, st.iters, dev)}


def _train_batch(st: Settings):
    """bench.py's training batch: `train_batch` rows of the 2-frame prompt
    padded to `prompt_len`, loss on all but the first 5 tokens, its frames."""
    ids = st.prompt_ids(st.train_batch)
    plan = fusion_mod.build_fusion_plan(
        ids, tokens_per_frame=st.tokens_per_frame, pad_to=st.prompt_len,
        labels=[[-100] * 5 + r[5:] for r in ids])
    return plan, st.frames(2 * st.train_batch)


def _stepper(cfg, params, optimizer, trainable_filter, micro: int = 1):
    """A call that runs `micro` train steps on one state, and drops it."""
    state = [trainer_mod.init_train_state(params, optimizer, trainable_filter)]
    step = trainer_mod.make_train_step(cfg, optimizer, trainable_filter=trainable_filter,
                                       remat=True)

    def fn(plan, frames):
        for _ in range(micro):
            state[0], loss = step(state[0], plan, frames)
        return loss

    fn.state = state
    return fn


def phase_train(st: Settings) -> dict:
    """LoRA train steps at the recipe's shapes (8-bit backbone + LoRA r128 /
    alpha 256 + trainable fp32 projector, bf16 tower, remat): tokens/s and MFU
    of a single optimizer step a call, then of the recipe's accumulation of
    8 (train_teochat.sh:26; one timed call of 8 micro-steps after a warm-up,
    as bench.py's one)."""
    cfg, dev = st.cfg, st.dev
    params = bridge.init_teochat(cfg, st.generator(), dev, st.dtype, quant="int8")
    params["llm"] = lora_mod.add_lora_params(st.generator(1), params["llm"], rank=128,
                                             alpha=256.0)
    params = trainer_mod.fp32_masters(params, lora_mod.lora_trainable_filter)
    batch, seq = st.train_batch, st.prompt_len
    plan, frames = _train_batch(st)
    optimizer = trainer_mod.make_optimizer(2e-4, projector_lr=2e-5, total_steps=100)
    one = _stepper(cfg, params, optimizer, lora_mod.lora_trainable_filter)
    dt = _timing.timeit(lambda: one(plan, frames), st.iters, dev)
    params = one.state.pop().params
    eight = _stepper(cfg, params, trainer_mod.MultiSteps(optimizer, 8),
                     lora_mod.lora_trainable_filter, micro=8)
    del params
    dt8 = _timing.timeit_all(lambda: eight(plan, frames), 1, dev, batches=1)[0]
    eight.state.clear()
    peak = measure_tensor_core_peak_tflops(st)
    tok_s, tok_s8 = batch * seq / dt, 8 * batch * seq / dt8
    return {
        f"train_step_s_bs{batch}_seq{seq}": dt,
        "train_tokens_per_sec": tok_s,
        "tensor_core_peak_tflops": peak,
        "train_mfu": _train_mfu(cfg.llm, tok_s, seq, peak, full_finetune=False),
        "train_tokens_per_sec_accum8": tok_s8,
        "train_mfu_accum8": _train_mfu(cfg.llm, tok_s8, seq, peak, full_finetune=False),
    }


def phase_train_bf16(st: Settings) -> dict:
    """bf16 full fine-tuning (bench.py's phase_train_bf16: every decoder and
    projector leaf trains, the tower frozen) of the TinyLlama-1.1B geometry:
    tokens/s and MFU of one optimizer step a call. The port trains fp32
    masters of the bf16 leaves (a bf16 weight rounds Adam's steps away), so
    its moments are fp32 too."""
    cfg, dev = st.cfg, st.dev
    llm = dataclasses.replace(cfg.llm, **st.train_bf16_llm)
    cfg = dataclasses.replace(cfg, llm=llm,
                              projector=dataclasses.replace(cfg.projector,
                                                            hidden_size=llm.hidden_size))
    params = bridge.init_teochat(cfg, st.generator(), dev, torch.bfloat16, quant=None)

    def trainable(path):
        return not path.startswith("vision")

    params = trainer_mod.fp32_masters(params, trainable)
    plan, frames = _train_batch(st)
    frames = frames.to(torch.bfloat16)
    step = _stepper(cfg, params, trainer_mod.make_optimizer(2e-5, total_steps=100), trainable)
    del params
    dt = _timing.timeit(lambda: step(plan, frames), st.iters, dev)
    step.state.clear()
    peak = measure_tensor_core_peak_tflops(st)
    tok_s = st.train_batch * st.prompt_len / dt
    return {
        "train_tokens_per_sec_bf16full_1b": tok_s,
        "train_mfu_bf16full_1b": _train_mfu(llm, tok_s, st.prompt_len, peak, full_finetune=True),
    }


def _engine_model(st: Settings) -> teochat_mod.TEOChat:
    """A TEOChat of the int8 decoder alone (the engine phases send no frames)."""
    llm = bridge.init_llama(st.cfg.llm, st.generator(), st.dev, st.dtype, quant="int8")
    return teochat_mod.TEOChat(st.cfg, {"llm": llm})


def _greedy(n_new: int) -> GenerationConfig:
    return GenerationConfig(max_new_tokens=n_new, temperature=0.0, do_sample=False,
                            stop_strings=())


def phase_serve(st: Settings) -> dict:
    """Continuous-batching serving throughput: `serve_requests` concurrent
    requests through the BatchEngine (per-request prefill, decode chunks
    replayed over all rows, host scheduling at chunk boundaries), the
    median of 3 runs after one warm-up request (its graph capture)."""
    n_req, max_new = st.serve_requests, st.serve_new
    gen = _greedy(max_new)
    prompts = [[1] + list(range(10 + i, 10 + i + st.serve_text)) for i in range(n_req)]
    with torch.no_grad():
        engine = BatchEngine(_engine_model(st), max_slots=n_req, max_len=st.serve_max_len,
                             chunk=st.serve_chunk).start()
        try:
            engine.submit(prompts[0], None, gen)

            def run_all():
                threads = [threading.Thread(target=engine.submit, args=(p, None, gen))
                           for p in prompts]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                return time.perf_counter() - t0

            dt = sorted(run_all() for _ in range(3))[1]
            return {
                f"serve_aggregate_tokens_per_sec_{n_req}streams": n_req * max_new / dt,
                f"serve_{n_req}x{max_new}tok_wall_s": dt,
                "serve_max_concurrent": engine.stats["max_concurrent"],
            }
        finally:
            engine.shutdown()


def _ttft_prefix_at(st: Settings, model, plen: int, max_len: int, pool: int):
    """(miss, hit) 1-token request times through the engine at one shared
    prefix of `plen` tokens (BOS and plen - 1 ids), with 3 tokens after it;
    the median of 3 each, after one request that pools the prefix and one
    that hits it (the warm-up of both paths)."""
    gen = _greedy(1)

    def prompt(base, i):
        return [1] + list(range(base, base + plen - 1)) + [2000 + i, 2100 + i, 5 + i]

    engine = BatchEngine(model, max_slots=2, max_len=max_len, chunk=4, prefix_cache_slots=pool,
                         prefix_min_tokens=st.prefix_min_tokens).start()
    try:
        engine.submit(prompt(100, 0), None, gen)
        engine.submit(prompt(100, 1), None, gen)

        def timed(base, i):
            t0 = time.perf_counter()
            engine.submit(prompt(base, i), None, gen)
            return time.perf_counter() - t0

        # hits first: with a pool of 2 the misses' stores evict the shared entry
        hit = sorted(timed(100, i) for i in (2, 3, 4))[1]
        miss = sorted(timed(b, 0) for b in (3000, 5000, 7000))[1]
        return miss, hit, engine.stats["prefix_tokens_saved"]
    finally:
        engine.shutdown()


def phase_ttft_prefix(st: Settings) -> dict:
    """Automatic prefix caching: TTFT of a request whose `prefix_len`-token
    text prefix is pooled (row copy + suffix prefill, K2m) beside one whose
    prefix is not (a monolithic prefill, K1), through the whole admission
    path (queue, prefill, first-token read)."""
    n = st.prefix_len + 3
    with torch.no_grad():
        miss, hit, saved = _ttft_prefix_at(st, _engine_model(st), st.prefix_len,
                                           st.prefix_max_len, pool=4)
    return {f"ttft_s_prefix_miss_{n}tok": miss, f"ttft_s_prefix_hit_{n}tok": hit,
            "prefix_hit_ttft_speedup": miss / hit, "prefix_tokens_saved": saved}


def phase_ttft_prefix_curve(st: Settings) -> dict:
    """The prefix hit / miss TTFT at each (prefix, max_len) of
    `prefix_curve` (bench.py's 128, 1024 and 2048; the 512 point is
    ttft_prefix), one model for all, a pool of 2 rows."""
    out = {}
    with torch.no_grad():
        model = _engine_model(st)
        for plen, max_len in st.prefix_curve:
            miss, hit, _ = _ttft_prefix_at(st, model, plen, max_len, pool=2)
            out[f"ttft_s_prefix_miss_{plen}tok"] = miss
            out[f"ttft_s_prefix_hit_{plen}tok"] = hit
            out[f"prefix_hit_ttft_speedup_{plen}"] = miss / hit
    return out


class _BenchTokenizer:
    """bench.py's whitespace tokenizer for the eval phase (random weights:
    ids only need to be stable and in the vocabulary)."""

    bos_token_id, eos_token_id = 1, 2

    def __init__(self):
        self.vocab, self.rev = {"<s>": 1, "</s>": 2}, {1: "<s>", 2: "</s>"}

    def __call__(self, text):
        ids = [1]
        for w in text.split():
            if w not in self.vocab:
                idx = 10 + len(self.vocab) % 30000
                self.vocab[w] = idx
                self.rev[idx] = w
            ids.append(self.vocab[w])
        return types.SimpleNamespace(input_ids=ids)

    def decode(self, ids):
        return " ".join(self.rev.get(int(i), ".") for i in ids)

    def batch_decode(self, ids_batch, skip_special_tokens=True):
        return [self.decode(i) for i in ids_batch]


def _raw_frames(st: Settings, n: int, rng: np.random.RandomState) -> np.ndarray:
    return rng.randint(0, 256, (n, *st.frame_hw, 3), np.uint8)


def phase_eval(st: Settings) -> dict:
    """Eval throughput: `eval_examples` synthetic 2-frame xBD-style examples
    through `run_inference_batched` (frames by the native ImageProcessor on
    a worker thread, one generate a batch) at `eval_batch` and at 1, the
    int8 model, greedy, `eval_new` new tokens."""
    cfg, dev = st.cfg, st.dev
    tok = _BenchTokenizer()
    model = teochat_mod.TEOChat(
        cfg, bridge.init_teochat(cfg, st.generator(), dev, st.dtype, quant="int8"),
        tokenizer=tok)
    processor = ImageProcessor(size=cfg.vision.image_size)
    rng = np.random.RandomState(0)
    dataset = [{
        "conversations": [
            {"value": "These are two satellite images of the same area before and after a "
                      f"disaster. <video> Is the building at [30{i % 10}, 283, 338, 308] "
                      "damaged?"},
            {"value": "yes"},
        ],
        "video": list(_raw_frames(st, 2, rng)),
        "timestamp": ["2020-01-01", "2020-03-01"],
        "task": "rqa",
    } for i in range(st.eval_examples)]
    out = {}
    with torch.no_grad():
        for bs in (st.eval_batch, 1):
            def run():
                run_inference_batched(
                    dataset, model, tok, processor, prompt_strategy="interleave",
                    chronological_prefix=True, conv_mode="v1", temperature=0.0,
                    max_new_tokens=st.eval_new, batch_size=bs, progress=False)

            out[f"eval_examples_per_sec_bs{bs}"] = st.eval_examples / _timing.timeit(run, 1, dev)
    b = st.eval_batch
    out[f"eval_bs{b}_vs_bs1"] = out[f"eval_examples_per_sec_bs{b}"] / out["eval_examples_per_sec_bs1"]
    return out


def phase_preprocess(st: Settings) -> dict:
    """The host alone: PIL against the native C++ preprocessing, frames/s."""
    from teochat_torch import native

    frames = list(_raw_frames(st, st.preprocess_n, np.random.RandomState(0)))
    pil = ImageProcessor(size=st.cfg.vision.image_size, use_native=False)
    out = {"preprocess_pil_frames_per_sec":
           len(frames) / _timing.timeit(lambda: pil.preprocess(frames), 3, "cpu")}
    if native.available():
        t_nat = _timing.timeit(lambda: native.preprocess_batch(
            frames, pil.size, pil.image_mean, pil.image_std), 3, "cpu")
        out["preprocess_native_frames_per_sec"] = len(frames) / t_nat
    return out


def phase_encode_pipeline(st: Settings) -> dict:
    """Sustained encode from raw uint8 frames to vision tokens, each path
    one batch deep: (A) the native host preprocessing on a worker thread
    while the card encodes the batch before; (B) `preprocess_frames` on the
    card (the host uploads uint8 only). Beside them the encode of frames
    already on the card, and the upload rate of one batch of raw frames.
    Each on the bf16 tower (the one eval and serve run) and, under keys
    ending `_w8a8`, on the w8a8 tower (bench.py's). Not run: bench.py's
    path C, which resizes on the host with cv2
    (`encode_sustained_fps_linkopt`): the card's machine has no cv2 (ROADMAP
    queue 1 item 10)."""
    cfg, dev = st.cfg, st.dev
    nb, bs, size = st.pipeline_batches, st.enc_batch, cfg.vision.image_size
    raw = [_raw_frames(st, bs, np.random.RandomState(i)) for i in range(nb)]
    proc = ImageProcessor(size=size)

    def prep_host(i):
        return proc.preprocess(list(raw[i]))["pixel_values"]

    out = {}
    with torch.no_grad():
        t_up = _timing.timeit(lambda: torch.from_numpy(raw[0]).to(dev), 1, dev)
    out["h2d_mbps"] = raw[0].nbytes / t_up / 1e6
    for suffix, quant in (("", None), ("_w8a8", "int8")):
        params = bridge.init_encoder(cfg, st.generator(), dev, st.dtype, vision_quant=quant)
        for key, value in _encode_pipeline_rates(st, params, raw, prep_host).items():
            out[key + suffix] = value
        del params
    return out


def _encode_pipeline_rates(st: Settings, params, raw, prep_host) -> dict:
    """`phase_encode_pipeline`'s paths through the tower of `params`."""
    cfg, dev = st.cfg, st.dev
    nb, bs, size = st.pipeline_batches, st.enc_batch, cfg.vision.image_size

    def encode(x):
        return teochat_mod.encode_frames(params, cfg, x)

    def run_host_path():
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(prep_host, 0)
            for i in range(nb):
                px = fut.result()
                if i + 1 < nb:
                    fut = pool.submit(prep_host, i + 1)
                encode(torch.from_numpy(px).to(dev, st.dtype))

    def run_device_path():
        for i in range(nb):
            encode(preprocess_frames(torch.from_numpy(raw[i]).to(dev), size).to(st.dtype))

    out = {}
    with torch.no_grad():
        out["encode_sustained_fps_hostpre"] = nb * bs / _timing.timeit(run_host_path, 1, dev)
        out["encode_sustained_fps_devicepre"] = nb * bs / _timing.timeit(run_device_path, 1, dev)
        staged = torch.from_numpy(prep_host(0)).to(dev, st.dtype)
        deviceonly = bs / _timing.timeit(lambda: encode(staged), nb, dev)
    out["encode_frames_per_sec_deviceonly"] = deviceonly
    out["encode_sustained_vs_deviceonly"] = max(
        out["encode_sustained_fps_hostpre"], out["encode_sustained_fps_devicepre"]) / deviceonly
    return out


PHASES: Dict[str, Callable[[Settings], dict]] = {
    "encode": phase_encode,
    "encode_w8a8": phase_encode_w8a8,
    "decode": phase_decode,
    "ttft_int8act": phase_ttft_int8act,
    "decode_bs8": phase_decode_bs8,
    "decode_bs16": phase_decode_bs16,
    "decode_bs32": phase_decode_bs32,
    "decode_int4": phase_decode_int4,
    "decode_spec": phase_decode_spec,
    "ttft_turn2": phase_ttft_turn2,
    "e2e": phase_e2e,
    "serve": phase_serve,
    "ttft_prefix": phase_ttft_prefix,
    "ttft_prefix_curve": phase_ttft_prefix_curve,
    "train": phase_train,
    "train_bf16": phase_train_bf16,
    "eval": phase_eval,
    "preprocess": phase_preprocess,
    "encode_pipeline": phase_encode_pipeline,
}

def run_phase(name: str, st: Settings) -> dict:
    if name not in PHASES:
        raise ValueError(f"unknown bench phase {name!r}; ported: {sorted(PHASES)}")
    out = PHASES[name](st)
    if st.dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", nargs="+", default=list(PHASES),
                        help=f"of: {' '.join(PHASES)}")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    st = Settings(seed=args.seed)
    if st.dev.type != "cuda":
        raise RuntimeError("the bench measures the card: it does not run on the CPU")
    smi = _timing.smi_line()
    print(smi, flush=True)
    results = {"device": torch.cuda.get_device_name(0), "smi": smi, "seed": args.seed}
    for name in args.phases:
        (out, seconds) = _timing.wall(lambda: run_phase(name, st), st.dev)
        print(f"# {name}: {seconds:.1f} s " + json.dumps(out), flush=True)
        results.update(out)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
