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
   0); each case twice, bit-equal; then its multi-query form (K2m) against
   its plain version on a session's suffix over a 4,096-slot cache at 7B
   shapes (S 1, 2, 5, 9, 128, 512, 1024, 2048; S 2, 5, 9 over a full cache, where
   the slots are split across blocks), starts 0, 1, 31, 32, 33, 63, 64, 65
   and 700 (the edges of 32- and 64-slot chunks), padded
   queries at the trash slot, a row with no live slot, head_dim 64 with
   group 4 and group 16, each twice, bit-equal, beside one
   `scaled_dot_product_attention` call with a boolean mask and the
   launch's row tile and slot splits; then the fp8 (e4m3) KV cache's
   kernels (`phase_fp8_kernels`): the card's bf16 -> e4m3 cast against the
   CPU's byte for byte on a fixed draw (values past 464 included), K2 on an
   e4m3 slab over the K2 cases (DECODE_TOL against its plain version, the
   bf16 K2's bits on the upcast slab, the same bits over a graph's replay;
   ms and GB/s of live KV beside the bf16 kernel's) and K2m on an e4m3 slab
   over K2M_CASES (held as the bf16 K2m, and the bf16 K2m's bits on the
   upcast slab), each beside SDPA on the bf16 upcast;
5. the int4 products (K3a flat, K3b tiled, K3c tiled and layer-stacked)
   against their plain version at the 7B projections' shapes, M = 1, 4 (the
   split-K `mma.sync` decode kernel), 16 and 768 (the M > 8 `wgmma`
   kernel), each beside `torch._weight_int4pack_mm` on the same weights;
6. the one-shot ViT attention (K5) against its plain version at the tower's
   shape for a 2-frame request and a 32-frame encode, at a ragged 100, at a
   336-pixel tower's 577 and at the gate's 1024;
7. the int4 path at TEOChat-7B width (ViT-L/14 through K5, mlp2x_gelu,
   LLaMA-7B's width with fused packed-int4 projections and an int4 lm_head,
   its depth cut to INT4_LAYERS of 32 to pay for phase 25; bf16
   activations, random weights from a seed): three requests
   through `run_inference_single` and one batched generate of four ragged
   rows; the launch counts of K1, K2, K3b, K3c and K5 must rise; then the
   decode steps as a replayed CUDA graph against the eager loop (the
   2-frame greedy request and the batch of four: the same tokens and
   launch counts; the largest difference of the last logits; ms/step both
   ways, the captures' seconds, the replays, the peak memory), and a
   capture that fails (a host read planted in the step) must raise; then
   prompt-lookup speculative decoding (`phase_spec`): greedy at k = 4 and 8
   on the 2-frame request and the batch of four through TEOChat.generate,
   the replayed verify graph against the eager loop (the same tokens,
   steps, accepted and launches; K2m num_layers times a verify iteration, K2
   never), a planted host read in the verify iteration failing its capture,
   each greedy token within SPEC_GAP_TOL of its position's largest logit in
   a teacher-forced prefill of the prompt and the emitted tokens (and where
   the spec tokens first leave the plain greedy ones), `generate_tokens_spec`
   with the bench's oracle on the `detection` and `regionqa` workloads (the
   oracle's 64 tokens exactly; tokens an iteration, acceptance, tok/s), a
   sampled run (t 0.8) giving the eager loop's tokens from the same seed,
   and ms a verify iteration at k = 1, 4, 7, 8 beside the plain graphed
   step, tok/s, captures and the peak memory; then generate over an e4m3
   KV cache (`phase_fp8_generate`) at batch 1 and 32 (rows of 2, 1 and 0
   frames): the graph's tokens against the eager loop's, the first token
   against the bf16 cache's, each token of three rows within SPEC_GAP_TOL
   of its teacher-forced maximum over an e4m3 cache (and its gap on the
   bf16 path printed), K2's e4m3 form launching and the bf16 one never; ms
   a step beside the bf16 cache's, both caches' GiB, the peak;
8. the prefill logits of that model with the int4 kernels against the same
   forward on the plain `int4_proj`;
9. one request through a 4-layer decoder at 7B width with 2 kv heads and
   unfused int4 projections, whose k and v are flat leaves: K3a must launch;
10. the checkpoint path at TEOChat-7B width and depth: a merged TEOChat
    checkpoint is written under `results/` (config.json, fp16
    `pytorch_model-0000k-of-0000n.bin` shards of 4 decoder layers, the
    ViT-L/14 tower embedded under its `vision_model` names, the mlp2x
    projector, a word-level tokenizer.json of 32000 tokens; random weights
    from the seed, drawn on the card and saved from the host: bytes and
    seconds); `teochat_torch.eval.eval.load_model(path, load_8bit=True)`
    loads it through the port's builder and `transformers`' tokenizer
    (seconds, the host's peak RSS, the card's peak during the load, which
    must stay below the loaded tree's bytes + 3 GiB: the 16-bit decoder is
    never on the card whole), and three sampled int8 projections,
    dequantized, must lie within half a quantization step of the
    checkpoint's fp16 weights; `eval("fmow_high_res", ...)` then runs 4
    examples of 2-4 uint8 frames of non-square sizes through the native
    `ImageProcessor` (which must have built: ms a frame), greedy, 32 new
    tokens (K1, K2 and K5 must launch; seconds an example, decode steps);
    the first example's truth is its greedy answer, taken by
    `run_inference` beforehand, so that the metrics are not empty and
    `eval()` must give that answer again; a second `eval()` with no model
    and no dataset must read its JSON and return the same metrics; then
    `eval(..., batch_size=4)` of the same examples, the split read through
    a stand-in `datasets.load_dataset` (which must be called with JAX's
    arguments): its answers beside batch 1's (the first difference), s an
    example both ways, K1, K2 and K5 launching; and `preprocess_frames` on
    the card on uint8 frames of 512 x 640, 100 x 120 (upsampled), 224 x 224
    and 300 x 200 against its CPU run (PREPROCESS_CPU_TOL) and the native
    ImageProcessor (mean |difference| within PREPROCESS_NATIVE_MEAN_TOL),
    ms a frame with and without the upload beside the native path's;
11. the int8 path on that loaded model: the requests of 7; K1, K2 and K5
    must launch; the graph against the eager loop (the 2-frame request and
    the batch of 4), speculative decoding (k 4; ms a verify iteration at k 4
    beside the plain step) and the e4m3 cache (batch 32) as in 7; then the last-position
    prefill logits of the 2-frame request with the kernels against the
    same forward on the plain attention;
12. the chat server on that loaded model: the port's `ChatServer` on
    127.0.0.1 and an ephemeral port, in the background; over HTTP session
    "a" takes four greedy turns of 32 tokens (two base64 PNG frames of
    non-square sizes with timestamps; text only; a frame whose timestamp
    sorts before the others, so the committed prefix changes from the first
    frame on; text with `"speculative_k": 4`, its tokens held to a
    teacher-forced prefill as in 7), session "b" one turn between a's first
    two; then /reset of "a" and /stats (a's spec_steps and spec_accepted).
    Each turn's last-position prefill logits in the session against a
    stateless prefill of the same conversation (relative L2 <= 5e-2), its
    tokens against a stateless generate's (printed: random 7B weights have
    near-ties); K1 and K5 must launch on a first turn, K2m on a's later
    turns, K2 on every turn but the spec turn (K2m alone); the session
    caches' GiB, the decode graph captures (one a session, and a's spec
    graph) and the peak; then, from fresh sessions, turn 2's time to first
    token beside a stateless re-prefill of the whole conversation and the
    session's decode ms/step;
13. the continuous-batching engine (`serve/engine.py`) on that loaded int8
    model: (a) `BatchEngine(max_slots=8, max_len=2048, chunk=8,
    prefill_chunk=256, prefix_cache_slots=2, prefix_min_tokens=256)` with
    eight requests from threads at once (2 and 4 uint8 frames, the 4-frame
    one ~1,200 fused tokens and so prefilled in pieces while the others
    decode; text; max_new_tokens 1; a stop string taken from its own greedy
    answer; sampled at t 0.8; two sharing a 321-token text prefix, the
    second sent once the first is answered, a pool hit): each greedy
    request's tokens beside a single-request `TEOChat.generate` (where they
    first differ) and each within SPEC_GAP_TOL of its position's largest
    logit in a teacher-forced prefill, the long prompt's pieces' last logits
    against a monolithic prefill, a prefix hit, K1, K2, K2m and K5
    launching, the graph's capture seconds and replays, the cache's GiB, the
    peak, and the longest wait of a running stream between two chunks; the
    engine's graph against its eager step over one chunk from the same state
    (tokens and launch counts, twice) and a host read planted in the step
    failing the capture; (b) `max_slots` 16, `max_len` 512: aggregate tok/s
    at 8 and 16 text streams of 121 + 64 tokens beside four of the requests
    one at a time through `TEOChat.generate`, with the card's name and power
    limit; (c) a 1-token request's time with a 512-token prefix pooled and
    not (bench `ttft_prefix`); then `ChatServer` in engine mode: four
    concurrent HTTP requests, one streamed by SSE whose token_ids equal a
    blocking request's, a session turn sent while the engine captures its
    graph (its prefill logits within LOGITS_REL_L2_BOUND of a stateless
    prefill), /stats in `continuous_batching` mode; (d) the eight requests
    of (a) through `BatchEngine(max_slots=8, max_len=2048, chunk=8,
    speculative_k=4, adaptive_spec=False, prefix_cache_slots=2)`: each
    greedy token within SPEC_GAP_TOL of its teacher-forced maximum and
    where it first leaves (a)'s, no K2 launch and K2m once a layer a verify
    iteration and a prefix hit; the speculative graph against its eager step
    over one chunk (tokens, counts, hist, positions, launches bit-equal,
    twice; the cache outside the trash slot) and a host read planted in the
    step failing the capture; ms a plain and a speculative chunk of 8 steps
    over 8 rows, both graphs over one state; (f) 8 text streams of 121 + 64
    tokens, four rounds, through the adaptive speculative engine (k 4, a
    re-probe every 4 plain chunks) beside two through the plain engine:
    tok/s, its mode switches and probes (at least one); (g) the
    eight requests of (a) through `BatchEngine(kv_dtype="float8_e4m3fn")`,
    plain (chunked prefill, a prefix hit) and speculative (k 4): each
    greedy token within SPEC_GAP_TOL of its teacher-forced maximum over an
    e4m3 cache, the e4m3 forms of K2 and K2m launching and the bf16 ones
    never, the cache's GiB; 8 streams of 121 + 64 tokens through an e4m3
    and a bf16 engine, tok/s; then multi-LoRA on that model
    (`phase_multi_lora`): (a) two peft dirs at full width (r 128, alpha
    256, A and B drawn from the seed) through `load_multi_lora` (the
    adapters' GiB, the card's peak); (b) adapters all 0, all 1 and all -1:
    the 2-frame request's prefill logits and the ragged batch of 4's greedy
    tokens bit-equal to the single-adapter models' (`attach_lora_to_llama`
    over the same base) and the base model's, graphed, and the graph's
    tokens the eager loop's; (c) one graph entry replayed with two adapter
    lists in turn, each run its eager run's tokens; (d) the engine with the
    eight requests of (a) over
    adapters {-1, 0, 1}, plain and speculative (k 4): each greedy token
    within SPEC_GAP_TOL of its adapter's teacher-forced maximum, a prefix
    hit refused across adapters and taken within one; (e) ms a graphed
    decode step with the base tree, one adapter and two stacked at bs 8,
    and the engine's tok/s at 8 streams mixed over {-1, 0, 1} against the
    base engine (one round each); (f) branch A: a `teochat-lora` dir over the
    checkpoint (one adapter dir's peft files, non_lora_trainables.bin with
    a projector of its own) loaded with load_8bit (seconds, the card's peak
    held below the tree + 3 GiB), one request;
14. `load_pretrained_model(path, load_int4=True)` from the same directory:
    one 2-frame request of uint8 frames (K3b and K3c must launch), then the
    serving engine with 4 text streams (K3b and K3c must launch), then a
    plain and a speculative chunk over 8 rows (ms each; the verify blocks'
    40 rows must take K3's M > 8 kernel), then multi-LoRA's (e) at bs 8
    over the fused int4 model; the directory is then removed,
    and after each model is deleted no decode graph may be left;
15. the training flash attention (K4a forward, the di preamble, K4b dK/dV,
    K4c dQ) against autograd through its plain twin at training shapes, at
    head_dim 64, on non-causal calls with S != T, on ragged lengths that
    leave the last tiles part-filled and on strided slices of a fused q|k|v;
    K4a's m and l against the plain row maximum and sum; di against its
    torch line; K4b and K4c from saved residuals against their tile walks
    (`flash_backward_dkv_schedule`, `_dq_schedule`) on the same bf16 inputs;
    and each kernel's time beside the plain forward's and backward's and the
    library's one backward call;
16. the training entry point on that checkpoint, while its directory
    exists (`phase_train_cli`): `teochat_torch.train.cli.main` with
    scripts/train_teochat.sh's flags (`--bits 8`, LoRA r128 / alpha 256 on
    all seven projections, fp32 projector masters, cosine schedule, batch
    4, accumulation 2, remat, `--save_steps 2`, `--dataloader_num_workers
    2`) on a local dataset dir of 16 synthetic 2-frame conversations (PNG
    frames): three optimizer steps, the three K4 launch counts at least
    layers x micro-steps, every adapter and projector leaf moved,
    checkpoint-2 holding the optimizer state and the final save none (F7);
    checkpoint-2 loaded, saved and loaded again bitwise; a second
    `cli.main` resuming from it to step 3; a 2-step projector-only run
    (`--lora_enable False --tune_mm_mlp_adapter True`) in which nothing but
    the projector moves; the load, s/step, tokens/s, a save's seconds and
    GB, a load's seconds, the resume's seconds and the peak (runs after
    phase 14, before the directory is removed);
17. one micro-step's loss and trainable gradients with the kernels against
    the same step on the plain attention; then phase 13 (e) on the loaded
    int8 model made the echo model in place (its last use: every layer's
    out and down projections zero, the lm_head the embedding shifted by
    one token, so the greedy successor of t is t + 1): 8 streams of a run
    of 80 ids and its first three again, 64 new tokens, through the
    speculative engine (k 4) and the plain one (the run's continuation
    from both, and from `TEOChat.generate`; tokens a verify iteration, which
    must exceed 1; tok/s both ways; ms a chunk both ways);
18. the kernel benches' eight variants (teochat_torch/bench/int4_kernel.py:
    v2, v3, v4, v5, vpu, dma; bench/vit_attention.py: b, c) against their
    plain versions: the int4 ones at K 4096, N 11008, M = 1 and 8, tiles of
    512, with `torch._weight_int4pack_mm` on the same weights beside v4 at
    M 1 and beside v2 and v5 at M 1 and 8; the attention ones at
    [32, 257, 16, 64] and [2, 257, 16, 64], at S 9 and 100, and at S 300
    and 832 (two sweeps);
19. the two kernel benches in-process (`int4_kernel.main(quick=True)`,
    `vit_attention.main()`): the eight launch counts, and those of K3b and
    K5 (their `v0` and `current` rows), must rise;
20. the main bench (`teochat_torch.bench.main`) with `--phases encode e2e
    train train_bf16`: the train phase's keys at accumulation 1 and 8, and
    bf16 full fine-tuning of the TinyLlama-1.1B geometry;
21. the vision extras, each part where its inputs are: (a) after phase 6,
    the w8a8 projection (`quantized_proj_act_i8`: per-token int8 activations,
    `int8_matmul` on torch._int_mm, the card's int8 tensor cores) at the
    tower's shapes (M 32 x 257, K 1024 -> N 1024 / 4096, K 4096 -> N 1024),
    the 7B prefill's (M 640: q, k, v, out; gate, up; down) and a 5-row
    suffix's (rows padded to 17): the int8 activations equal the CPU's and
    the int32 sums the exact product, bit for bit; ms beside the w8a16
    projection, a bf16 `torch.matmul` and the int8 bound; (b) 32 frames
    through ViT-L/14 and the projector after `quantize_vit_params`: the
    vision tokens' relative L2 (W8A8_TOWER_REL_L2) and cosine against the
    bf16 tower's, K5's launches, frames/s both ways; (e) the audio tower
    (126 x 1036 spectrograms, S 667 through K5) and the video tower (8
    frames) at full width, K5 at S 667 against its plain version; (c) after
    phase 11, the loaded 8-bit model with `int8_prefill_activations` (no
    reload): TTFT beside the w8a16 prefill's in turns, greedy tokens within
    SPEC_GAP_TOL of a teacher-forced maximum, K1 and the int8 products
    counted (none in a decode graph), a session's turn 2 and an engine
    request replaying their graphs; (d) the checkpoint with
    `mm_use_im_start_end` and `mm_use_im_patch_token` set, loaded with
    `load_8bit` (five tokens added, the embedding and the int8 lm_head
    grown; seconds and peak beside phase 10's), one `eval()` example whose
    prompt wraps each <image>;
22. the MPT backend, after phase 6 (its own generator): (a) K1's `bias_k`
    branch against its plain twin with MPT-7B's ALiBi table for a 4,096-slot
    cache at the 2-frame prefill's shape, the multiquery case (one kv head)
    and a ragged S, ms beside the bias-free K1 in the same call, the plain
    twin and SDPA with a float mask; K4a's o, m and l
    with the bias; (b) LLaVA-MPT at MPT-7B's width and depth, int8 (random
    weights): a 2-frame greedy request of 32 tokens through
    TEOChat.generate, K1's bias branch launching once a layer for the
    prefill, TTFT and decode tok/s, the prefill's last logits against plain
    attention (LOGITS_REL_L2_BOUND); (c) its decode graph's tokens and
    last logits bit-equal to the eager loop's, twice; (d) a speculative
    greedy request (k 4); (e) a session's turn 2 and an engine request,
    (d) and (e) each the plain greedy tokens or within SPEC_GAP_TOL of a
    teacher-forced maximum at a near-tie;
23. MPT training, after phase 22 and on its drawn int8 LLaVA-MPT-7B (no
    second draw): (a) K4b's and K4c's `bias_k` branches against their tile
    walks on the same bf16 inputs, m, l and di (WALK_REL_*) at B4 S1024 H32
    D128 with MPT-7B's table sized to S (the training shape), multiquery
    (one kv head) at a ragged S 700, and with the first 768 keys of a
    4,096-slot table (each head's last bias far from 0); the trainable path
    with the table against autograd of the plain attention (GRAD_REL_*);
    K4a, K4b and K4c with the bias timed at the training shape beside the
    bias-free kernels, the plain twin's forward and backward and
    `scaled_dot_product_attention` with phase 22's shifted bf16 mask
    (forward, and dq, dk, dv in one backward call); (b) 3 optimizer steps of
    `train.train.train` with the recipe's LoRA r128 / alpha 256 over the
    int8 backbone, batch 2 (about 640 fused tokens), remat, on phase 16's
    synthetic 2-frame conversations: the losses finite and positive, every
    adapter of the four projections and the projector moved, the int8
    kernels bitwise unchanged, K4a-c launched with the bias only (K4a twice
    a layer under remat, K4b and K4c once) and never without; s a step,
    valid tokens/s and the peak; (c) one micro-step's loss and LoRA and
    projector gradients with the kernels against attn_impl='plain' on those
    weights and one batch (phase 17's bounds). The model is freed after.
24. the (data, fsdp, model) mesh, after phase 17 (`phase_mesh`,
    `phase_tower_train`): (a) two ranks of this script (`--ranks DIR`) on
    the one card, gloo over CUDA tensors (NCCL refuses two ranks on one
    device: `chip_probe.py two-ranks`), all-gather, reduce-scatter,
    all-reduce and broadcast run; (b) LLaMA-7B's width cut to P24_LAYERS
    layers, random int8 weights and LoRA r128 from seed 0, batch 2 x 1,024,
    remat: 2 optimizer steps on mesh (1, 2, 1), then 2 on (1, 1, 2), their
    losses and every trained leaf's change against one rank's on the same
    batches (P24_LOSS_REL, P24_LEAF_REL); s a step, the collectives' share
    of it, GiB a rank; (c) the (1, 2, 1) run's sharded saves at steps 1 and
    2, pruned to one, loaded on one process (the trained leaves bitwise the
    gathered shards, the frozen ones the seed's), s and GB, and a resume of
    one step against one rank's third; (d) TinyLlama-1.1B's geometry with
    the full ViT-L/14 tower, bf16 full fine-tuning, 2 steps of `train()`:
    the tower's attention on K4a-c non-causal (launches counted exactly, K5
    none), every tower leaf the loss reaches moved, the peak; a tiny tower's
    gradients on the card against the CPU's (TOWER_TRAIN_GRAD_REL).
25. context and pipeline parallelism, after phase 24 (`phase_context_pipe`:
    two ranks of this script, `--ranks25 DIR`, phase 24's launcher and
    config helpers): (a) the point-to-point transport (gloo's send / recv
    abort on CUDA tensors, so `exchange` stages through pinned host
    buffers, counted); (b) the ring alone at LLaMA-7B's attention shape
    (P25_RING: B 2, S 4,096 split 2 x 2,048, H 32, D 128, causal) on K4a-c
    against the plain twin in fp32 (phase 17's bounds), its launches (3 of
    each kernel over the ranks), ms a step beside the rotations' share and
    one rank's K4a-c over the whole S; (c) the recipe's trainable set on
    mesh (1, 1, 1, sequence 2), batch 2 x 2,048, (d) on (1, 1, 1, 1, pipe 2),
    batch 4 x 1,024 at 2 and 4 microbatches, (e) LLaVA-MPT-7B's width cut to
    P25_MPT_LAYERS layers on pipe 2, one step, K4a-c with the bias only;
    each against one rank's run on the same batches (phase 24's bounds:
    losses, the first step's gradients, the leaves after), launches exact,
    s a step, the collectives' and sends' share, GiB a rank; (f) the pipe
    mesh's sharded save loaded on one process bitwise, its config without
    the run's axes.

Every path runs at full width and depth. Beside each kernel's time the run
takes the time of its plain version, of the one PyTorch call that computes
the same function where there is one (`scaled_dot_product_attention`,
`torch._weight_int4pack_mm`; used nowhere in the port), and works out the
least time the card could take:
the larger of the bytes moved over 3.35 TB/s and the operations over
989 TFLOP/s (bf16; 1,979 TOP/s for an int8 product), the H100 SXM's
published rates.

The line before the last is a JSON object with each of the twenty-five
kernel rows' launches, error, times and bound (K1 twice: bias-free, its
launches the int4 path's, and with MPT's bias, its launches the MPT
request's; K4a, K4b and K4c twice: bias-free, their launches phase 16's
`cli.main`, phase 24's ranks, its one-rank reference and resume, its
tower's `train()` and phase 25's ranks' sequence and pipe runs, and with
MPT's bias, their launches phase 23's `train()` and phase 25's MPT pipe
run; K5's add phase 24's ranks' frozen tower; K2
and K2m twice: on a bf16
and on an e4m3 cache; the e4m3 rows' launches are the int4 path's e4m3
generate's and the e4m3 engine's), the e4m3 generate's numbers under
"fp8_generate", the engine phase's
numbers under "engine", the batched eval's and preprocessing's under
"eval", multi-LoRA's under "multi_lora", phase 21's under
"vision_extras", phases 22 and 23's under "mpt" (phase 23's under its
"train"), phases 24 and 25's under "mesh" (25's under its
"context_pipe"); K3c has two: its wrapper runs the M > 8 kernel at prefill
and the split-K one at decode; K2m's launches are the chat server's five
turns, the spec turn's verify blocks among them); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import os
import shutil
import statistics
import sys
import tempfile
import threading
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
from teochat_torch.config import GenerationConfig, MptConfig, TEOChatConfig, VisionConfig
from teochat_torch.constants import IMAGE_TOKEN_INDEX, OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
from teochat_torch.eval.classification import classification_metrics
from teochat_torch.eval.inference import run_inference, run_inference_single
from teochat_torch.mm_utils import tokenizer_image_token
from teochat_torch.checkpoint.bridge import init_encoder, init_teochat
from teochat_torch.data.dataset import DataArguments, make_supervised_data_module
from teochat_torch.models import fusion as fusion_mod
from teochat_torch.models import generation as gen_mod
from teochat_torch.models import llama as llama_mod
from teochat_torch.models import mpt as mpt_mod
from teochat_torch.models import teochat as teochat_mod
from teochat_torch.models.vit import layer_index
from teochat_torch.ops import _build
from teochat_torch.ops import decode_attention as dec_mod
from teochat_torch.ops import flash_attention as flash_mod
from teochat_torch.ops import int4_matmul as int4_mod
from teochat_torch.ops import quant as quant_mod
from teochat_torch.ops import vit_attention as vit_mod
from teochat_torch.serve import engine as engine_mod
from teochat_torch.serve.session import ChatSession
from teochat_torch.train.lora import (
    LORA_TARGET_GROUPS,
    MPT_TARGET_NAMES,
    add_lora_params,
    lora_trainable_filter,
)
from teochat_torch.train.trainer import fp32_masters, partition_params, tree_leaves_with_path

SEED = 0
# the int4 path's depth (phase 7), cut from 32 to pay for phase 25's time
INT4_LAYERS = 16
# |kernel (bf16 out) - plain (fp32 on the same bf16 inputs)|: outputs are
# averages of N(0, 1) values, |o| < 4, so bf16 output rounding alone is up to
# 2^-8 * 4 = 1.6e-2; P is rounded to bf16 before PV, as on the TPU
FLASH_TOL = 2e-2
DECODE_TOL = 2e-2
# K2m, each live (query, head) row's largest error over its largest |o|. A
# query over ~4,000 slots averages them to |o| ~ 0.07, so DECODE_TOL alone
# would pass a slot split that drops a chunk or weighs one split wrong;
# these bounds scale with the row. Against the plain version (fp32 P) the
# kernel's bf16 P and bf16 output differ; against its walk on the same bf16
# K / V (P rounded to bf16 as the kernel rounds it, o left in fp32) only the
# output's rounding, up to 2^-8 of the row's largest |o|, and the order of
# fp32 sums are left. Read on an H100 over K2M_CASES (chip_probe.py k2m and
# this phase, two draws): 3.4e-3 to 5.7e-3 against the plain version, 3.1e-3
# to 4.1e-3 against the walk. Planted in copies of decode_attention.cu: split 1's first chunk
# dropped reads 0.21 to 0.35 against both, split 0 counting it again 0.20
# to 0.33, split 1's merge factor 5 % high 3.8e-2 to 5.0e-2 and 1 % high
# 8.6e-3 to 1.2e-2 against the walk, where DECODE_TOL passes the last two
K2M_REL_MAX = 1e-2
K2M_WALK_REL_MAX = 5e-3
# ||logits(kernels) - logits(plain)|| / ||logits(plain)|| after 32 bf16 layers;
# it holds the MPT-7B-width request too (K1 with its ALiBi bias against plain
# attention), read 1.707e-02 there on an H100 80GB HBM3 at 700 W: the bias
# adds little (the plain twin rounds it at an ulp of 2.4e-4, the kernel after
# shifting each head's table)
LOGITS_REL_L2_BOUND = 5e-2
# The MPT phase's ALiBi table is sized to a 4,096-slot cache, as mpt_forward
# sizes it to its cache: a prefill's biases reach -3,443 there
MPT_TABLE_SLOTS = 4096
# K4a's m with the bias: near -3,000, where an ulp is 2.4e-4; four of them
MPT_STAT_M_TOL = 1e-3
# A greedy token of the speculative path against one teacher-forced prefill
# of the prompt and the emitted tokens: its distance from its position's
# largest logit, in rms units of that position's logits. Two correct bf16
# paths differ by up to LOGITS_REL_L2_BOUND of the logits' norm, ~5e-2 rms
# an element; the largest of 32,000 such differences is ~4.5 of that, and a
# token the other path picks can sit below the maximum by two of them (read
# on an H100: up to 7.2e-2 at int4, 5.2e-2 at int8), while the largest of
# 32,000 normal logits stands ~4 above a typical one
SPEC_GAP_TOL = 0.5
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


def _suffix_case(b, s, t, starts, live):
    """q_slots [B, S] and kv_mask [B, T] of a session's suffix prefill: row b's
    live queries at slots starts[b], starts[b] + 1, ..., its padded ones at
    the trash slot t - 1, kv_mask the prefix starts[b] + live[b]."""
    starts = torch.tensor(starts, device="cuda")[:, None]
    live = torch.tensor(live, device="cuda")[:, None]
    pos = torch.arange(s, device="cuda")[None, :]
    q_slots = torch.where(pos < live, starts + pos, t - 1)
    kv_mask = torch.arange(t, device="cuda")[None, :] < starts + live
    return q_slots, kv_mask


# K2m's cases, (B, S, H, Hkv, T, D, starts, live): a session's suffix over a
# 4,096-slot cache at 7B shapes. Literals, so that `chip_probe.py k2m` can
# read them from this file and time another checkout's kernel on them.
K2M_CASES = [
    (1, 1, 32, 32, 4096, 128, [700], [1]),
    (1, 2, 32, 32, 4096, 128, [4094], [2]),  # speculative verify at k = 1, a full cache
    (1, 5, 32, 32, 4096, 128, [4091], [5]),  # k = 4
    (1, 9, 32, 32, 4096, 128, [700], [9]),
    (1, 9, 32, 32, 4096, 128, [4080], [9]),  # a full cache: each query over ~4,089 slots
    (1, 128, 32, 32, 4096, 128, [700], [100]),  # a text turn's suffix: the reported case
    (1, 512, 32, 32, 4096, 128, [700], [512]),
    (1, 1024, 32, 32, 4096, 128, [100], [874]),  # a turn that re-prefills three frames
    (1, 2048, 32, 32, 4096, 128, [0], [2048]),  # the engine's suffix bucket of 2048
    # starts at the edges of 32- and 64-slot chunks
    (9, 9, 32, 32, 4096, 128, [0, 1, 31, 32, 33, 63, 64, 65, 700], [9, 9, 9, 9, 5, 9, 9, 9, 9]),
    (2, 128, 32, 32, 4096, 128, [63, 0], [128, 0]),  # row 1 has no live slot
    (2, 33, 16, 4, 1024, 64, [64, 65], [33, 20]),  # head_dim 64, group 4
    (1, 17, 32, 2, 600, 128, [65], [17]),  # group 16
    (1, 3, 16, 4, 2048, 64, [2040], [3]),  # head_dim 64, group 4, slots split across blocks
]


def k2m_errors(q, k, v, lens, got):
    """K2m's output `got` for q, k, v, lens against its plain version and
    its walk for this card's SMs: (the largest absolute error of a live
    query, the largest of each live (query, head) row's error over the row's
    largest |o| against the plain version, the same against the walk)."""
    alive = lens > 0
    want = dec_mod.decode_attention_multi_plain(q.float(), k.float(), v.float(), lens)
    walk = dec_mod.decode_attention_multi_schedule(q.float(), k, v, lens,
                                                   sms=_build.sm_count(q.device))

    def row_rel(ref):
        return ((got.float() - ref).abs().amax(-1)[alive] / ref.abs().amax(-1)[alive]).max().item()

    return (got.float() - want)[alive].abs().max().item(), row_rel(want), row_rel(walk)


def phase_decode_multi(gen):
    """K2m, decode attention's multi-query form, against its plain version
    on K2M_CASES: queries of a session's suffix over a 4,096-slot cache at
    7B shapes (S 1, 2, 5, 9, 128, 512, 1024; S 2, 5 and 9 also at the
    cache's end), starts 0, 1, 31, 32, 33, 63, 64, 65 and 700, padded
    queries at the trash slot, a row with no live slot (written as 0),
    head_dim 64 with group 4 and group 16; each case twice, bit-equal, and
    each (query, head) row held to its own size against the plain version
    and the walk (`k2m_errors`); beside one scaled_dot_product_attention
    call with a boolean mask, with the launch `multi_plan` picks (row
    groups, slot splits)."""
    cases = K2M_CASES
    worst, main = 0.0, None
    for b, s, h, hkv, t, d, starts, live in cases:
        # a layer slab of the [L, B, T, Hkv, D] cache, read in place as [B, Hkv, T, D]
        k_slab, v_slab = _randn((b, t, hkv, d), gen), _randn((b, t, hkv, d), gen)
        k, v = k_slab.transpose(1, 2), v_slab.transpose(1, 2)
        q = _randn((b, s, h, d), gen)
        q_slots, kv_mask = _suffix_case(b, s, t, starts, live)
        lens = dec_mod.query_lengths(q_slots, kv_mask)
        got = dec_mod.decode_attention_multi(q, k, v, lens)
        again = dec_mod.decode_attention_multi(q, k, v, lens)
        sync()
        check(torch.equal(got, again), "K2m: the same bits on a second call")
        alive = lens > 0  # the plain version gives the mean of V where the kernel gives 0
        check(got[~alive].abs().sum().item() == 0.0, "K2m: a query without live slots is 0")
        check(torch.isfinite(got).all().item(), "K2m output finite")
        err, rel, walk_rel = k2m_errors(q, k, v, lens, got)
        ms = time_ms(lambda: dec_mod.decode_attention_multi(q, k, v, lens))
        plain_ms = time_ms(lambda: dec_mod.decode_attention_multi_plain(q, k, v, lens))
        lib_ms = None
        if alive.all():
            mask = torch.arange(t, device="cuda")[None, None, :] < lens[..., None]
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                _bhsd(q), k, v, attn_mask=mask[:, None], enable_gqa=hkv != h))
        # bytes: q and o once, each row's K and V up to its longest query once;
        # operations: QK and PV over each query's live slots
        kv_read = int(lens.amax(-1).sum().item()) * hkv * d * 2 * 2
        row = kernel_row(err, ms, plain_ms, kv_read + 2 * 2 * b * s * h * d,
                         4 * int(lens.sum().item()) * h * d, lib_ms)
        lib_text = "n/a (a query without live slots)" if lib_ms is None else f"{lib_ms:.4f} ms"
        rw, splits, _ = dec_mod.multi_plan(b, s, h, hkv, t, _build.sm_count(q.device))
        log(f"[K2m decode multi] B={b} S={s} H={h} Hkv={hkv} D={d} T={t} starts={starts} "
            f"live={live} rows a block {16 * rw} splits {splits}: max_abs_err={err:.3e} "
            f"(tol {DECODE_TOL}), of a row's largest |o| {rel:.3e} (bound {K2M_REL_MAX}), "
            f"against the walk {walk_rel:.3e} (bound {K2M_WALK_REL_MAX}); kernel {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms scaled_dot_product_attention with the mask {lib_text} "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        check(err <= DECODE_TOL, f"K2m error {err} > {DECODE_TOL}")
        check(rel <= K2M_REL_MAX, f"K2m error {rel} of a row's largest |o| > {K2M_REL_MAX}")
        check(walk_rel <= K2M_WALK_REL_MAX,
              f"K2m against its walk: {walk_rel} of a row's largest |o| > {K2M_WALK_REL_MAX}")
        worst = max(worst, err)
        if (b, s, starts) == (1, 128, [700]):
            main = row
    main["max_abs_err"] = worst
    return main


E4M3 = torch.float8_e4m3fn


def _e4m3_slab(shape, gen):
    """A layer slab of an e4m3 [L, B, T, Hkv, D] cache read in place as
    [B, Hkv, T, D], and its exact bf16 upcast."""
    slab = _randn((2, *shape), gen).to(E4M3)[1].transpose(1, 2)
    return slab, slab.to(torch.bfloat16)


def _graph_replay_bits(fn):
    """`fn()`'s output from a CUDA graph's replay: (eager, replayed), after a
    warm-up on a side stream (the tickets exist before the capture)."""
    eager = fn()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    graph.replay()
    sync()
    return eager, out


def phase_fp8_kernels(gen):
    """The fp8 (e4m3) KV cache's kernels: (a) the card's bf16 -> e4m3 cast
    gives the CPU's bytes on a fixed draw, the values at and past 448
    included; (b) K2 on an e4m3 slab over phase_decode's cases against its
    plain version (DECODE_TOL), bit-equal to the bf16 K2 on the upcast slab
    and over a CUDA graph's replay, ms and GB/s of live KV beside the bf16
    kernel's; (c) K2m on an e4m3 slab over K2M_CASES held as phase_decode_multi
    holds the bf16 kernel, bit-equal to the bf16 K2m on the upcast slab.
    Returns the two kernel rows (bound at one byte a cached value; the
    library call is SDPA on the bf16 upcast: none reads e4m3 in place)."""
    rs = np.random.RandomState(SEED)
    x = torch.from_numpy(np.concatenate([
        rs.randn(200_000) * 60, [448, 464, 466, 480, 1e4, -448, -464, -466, -480, -1e4]])
        .astype(np.float32)).to(torch.bfloat16)
    cpu, card = x.to(E4M3).view(torch.uint8), x.cuda().to(E4M3).view(torch.uint8).cpu()
    past = x.float().abs() > 464
    log(f"[fp8 cast] {x.numel()} bf16 values, {int(past.sum())} past 464: the card's e4m3 bytes "
        f"{'equal' if torch.equal(cpu, card) else 'DIFFER from'} the CPU's; "
        f"past 464 both saturate: {sorted(set(card[past].tolist()))}")
    check(torch.equal(cpu, card), "fp8 cast: the card's bytes differ from the CPU's")

    c = dec_mod.CHUNK
    ragged = [1025, 1, 517, 1024, 64, 300, 1000, 2]
    cases = [  # phase_decode's; the first is reported in the JSON line
        (1, 32, 32, 801, [580], 128), (4, 32, 32, 1553, [1100, 1080, 1120, 60], 128),
        (8, 32, 32, 1025, ragged, 128), (8, 32, 8, 1025, ragged, 128),
        (1, 32, 2, 300, [290], 128), (5, 32, 32, 801, [1, c - 1, c, c + 1, 801], 128),
        (5, 16, 16, 300, [1, c - 1, c, c + 1, 300], 64), (3, 32, 32, 801, [0, 580, 0], 128),
    ]
    worst, k2 = 0.0, None
    for b, h, hkv, t, lengths, d in cases:
        k8, kb = _e4m3_slab((b, t, hkv, d), gen)
        v8, vb = _e4m3_slab((b, t, hkv, d), gen)
        q = _randn((b, h, d), gen)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        got, replayed = _graph_replay_bits(lambda: dec_mod.decode_attention(q, k8, v8, lens))
        bf16 = dec_mod.decode_attention(q, kb, vb, lens)
        sync()
        check(torch.equal(got, bf16), "K2 e4m3: not the bf16 kernel's bits on the upcast slab")
        check(torch.equal(got, replayed), "K2 e4m3: a graph's replay gives other bits")
        live = lens > 0
        want = dec_mod.decode_attention_plain(q.float(), k8, v8, lens)
        err = (got.float() - want)[live].abs().max().item()
        check(got[~live].abs().sum().item() == 0.0, "K2 e4m3: a row without live slots is 0")
        ms = time_ms(lambda: dec_mod.decode_attention(q, k8, v8, lens))
        bf16_ms = time_ms(lambda: dec_mod.decode_attention(q, kb, vb, lens))
        plain_ms = time_ms(lambda: dec_mod.decode_attention_plain(q, k8, v8, lens))
        n_live = int(lens.sum().item())
        lib_ms = None
        if live.all():
            mask = torch.arange(t, device="cuda")[None, :] < lens[:, None]
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None, :], kb, vb, attn_mask=mask[:, None, None, :], enable_gqa=hkv != h))
        kv8 = 2 * n_live * hkv * d  # bytes of live K and V, one a value
        row = kernel_row(err, ms, plain_ms, kv8 + 2 * 2 * b * h * d, 4 * n_live * h * d, lib_ms)
        log(f"[K2 e4m3] B={b} H={h} Hkv={hkv} D={d} T={t} lengths={lengths}: max_abs_err="
            f"{err:.3e} (tol {DECODE_TOL}); bit-equal to the bf16 kernel on the upcast slab and "
            f"over a graph's replay; kernel {ms:.4f} ms ({kv8 / ms / 1e6:.1f} GB/s of live KV) "
            f"against bf16 {bf16_ms:.4f} ms ({2 * kv8 / bf16_ms / 1e6:.1f} GB/s); plain "
            f"{plain_ms:.4f} ms; SDPA on the bf16 upcast "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}; bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")
        check(err <= DECODE_TOL, f"K2 e4m3 error {err} > {DECODE_TOL}")
        worst = max(worst, err)
        k2 = k2 or dict(row, bf16_ms=bf16_ms)
    k2["max_abs_err"] = worst

    worst, k2m = 0.0, None
    for b, s, h, hkv, t, d, starts, live in K2M_CASES:
        k8, kb = _e4m3_slab((b, t, hkv, d), gen)
        v8, vb = _e4m3_slab((b, t, hkv, d), gen)
        q = _randn((b, s, h, d), gen)
        lens = dec_mod.query_lengths(*_suffix_case(b, s, t, starts, live))
        got = dec_mod.decode_attention_multi(q, k8, v8, lens)
        again = dec_mod.decode_attention_multi(q, k8, v8, lens)
        bf16 = dec_mod.decode_attention_multi(q, kb, vb, lens)
        sync()
        check(torch.equal(got, again), "K2m e4m3: the same bits on a second call")
        check(torch.equal(got, bf16), "K2m e4m3: not the bf16 kernel's bits on the upcast slab")
        alive = lens > 0
        check(got[~alive].abs().sum().item() == 0.0, "K2m e4m3: a query without live slots is 0")
        err, rel, walk_rel = k2m_errors(q, k8, v8, lens, got)
        check(err <= DECODE_TOL and rel <= K2M_REL_MAX and walk_rel <= K2M_WALK_REL_MAX,
              f"K2m e4m3 {b, s, starts}: {err}, {rel} of a row's |o|, {walk_rel} against the walk")
        worst = max(worst, err)
        ms = time_ms(lambda: dec_mod.decode_attention_multi(q, k8, v8, lens))
        bf16_ms = time_ms(lambda: dec_mod.decode_attention_multi(q, kb, vb, lens))
        line = (f"[K2m e4m3] B={b} S={s} H={h} Hkv={hkv} D={d} T={t} starts={starts} live={live}: "
                f"max_abs_err={err:.3e}, of a row's largest |o| {rel:.3e} (bound {K2M_REL_MAX}), "
                f"against the walk {walk_rel:.3e} (bound {K2M_WALK_REL_MAX}); bit-equal to the "
                f"bf16 kernel on the upcast slab; kernel {ms:.4f} ms against bf16 {bf16_ms:.4f} ms")
        if (b, s, starts) == (1, 128, [700]):
            plain_ms = time_ms(lambda: dec_mod.decode_attention_multi_plain(q, k8, v8, lens))
            mask = torch.arange(t, device="cuda")[None, None, :] < lens[..., None]
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                _bhsd(q), kb, vb, attn_mask=mask[:, None], enable_gqa=hkv != h))
            kv8 = int(lens.amax(-1).sum().item()) * hkv * d * 2
            k2m = dict(kernel_row(err, ms, plain_ms, kv8 + 2 * 2 * b * s * h * d,
                                  4 * int(lens.sum().item()) * h * d, lib_ms), bf16_ms=bf16_ms)
            line += (f"; plain {plain_ms:.4f} ms, SDPA on the bf16 upcast {lib_ms:.4f} ms, bound "
                     f"{k2m['bound_ms']:.4f} ms ({k2m['bound_by']})")
        log(line)
    k2m["max_abs_err"] = worst
    return k2, k2m


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
    "K1": flash_mod.LAUNCHES, "K1 bias": flash_mod.LAUNCHES_BIAS, "K2": dec_mod.LAUNCHES, "K3a": int4_mod.LAUNCHES_FLAT,
    "K3b": int4_mod.LAUNCHES_TILED, "K3c": int4_mod.LAUNCHES_STACKED,
    "K3c M<=8": int4_mod.LAUNCHES_STACKED_SMALL_M, "K5": vit_mod.LAUNCHES,
    "K2m": dec_mod.LAUNCHES_MULTI, "K2 e4m3": dec_mod.LAUNCHES_E4M3,
    "K2m e4m3": dec_mod.LAUNCHES_MULTI_E4M3,
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


G16 = GenerationConfig(max_new_tokens=16, temperature=0.0, do_sample=False)


def ragged_batch(tokenizer, processor):
    """The ids and frames of one batch of four ragged rows (2, 1, 4 and 0 frames)."""
    rows = [
        (PROMPT_2.replace("<video>", "Image 1: <image> Image 2: <image>"), 2),
        ("Describe the land use in this image: <image>", 1),
        (PROMPT_4.replace("<video>", " ".join(f"Image {i + 1}: <image>" for i in range(4))), 4),
        ("What is a satellite image?", 0),
    ]
    batch_ids = [tokenizer_image_token(p, tokenizer, IMAGE_TOKEN_INDEX) for p, _ in rows]
    batch_frames = np.concatenate(
        [processor.preprocess(["x"] * n)["pixel_values"] for _, n in rows if n], axis=0)
    return batch_ids, batch_frames


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

    batch_ids, batch_frames = ragged_batch(tokenizer, processor)
    outs, sec = wall(lambda: model.generate(batch_ids, batch_frames, G16, rng=SEED))
    check(len(outs) == 4 and all(0 < len(r) <= 16 for r in outs), "batched lengths")
    check(all(0 <= t < cfg.llm.vocab_size for r in outs for t in r), "batched token ids")
    log(f"[{tag}] batched generate of 4 ragged rows (prompt lengths "
        f"{[len(r) for r in batch_ids]}): {sec:.3f} s, tokens per row {[len(r) for r in outs]}")
    return ids, frames


@contextlib.contextmanager
def decode_loop(graphed):
    """Route generate's decode steps to the replayed CUDA graph (True) or to
    the eager loop on the card (False), through the module's private helper;
    yields a dict holding the last call's last logits."""
    saved, last = gen_mod.generate_tokens, {}

    def run(*args, **kwargs):
        tokens, n_gen, state = gen_mod._generate_tokens(*args, **kwargs, graphed=graphed)
        last["logits"] = state.logits.clone()
        return tokens, n_gen

    gen_mod.generate_tokens = run
    try:
        yield last
    finally:
        gen_mod.generate_tokens = saved


def phase_decode_graph(model, tokenizer, processor, ids, frames, tag, batch16=True):
    """The decode steps as a replayed CUDA graph against the eager loop, on
    this card: the 2-frame greedy request (32 tokens), the 4-row ragged
    batch of the main path and, with `batch16`, that batch four times over
    (16 rows: the int4 step runs K3's M > 8 kernel in the graph) give the
    same tokens and the same kernel counts both ways; ms/step both ways
    (medians of 3 generates of 1 and of 32 tokens), the captures' seconds,
    the replays and the peak memory."""
    batch_ids, batch_frames = ragged_batch(tokenizer, processor)
    ids16, frames16 = batch_ids * 4, np.concatenate([batch_frames] * 4, axis=0)
    g1 = GenerationConfig(max_new_tokens=1, temperature=0.0, do_sample=False, stop_strings=())
    g32 = GenerationConfig(max_new_tokens=32, temperature=0.0, do_sample=False, stop_strings=())
    gen_mod.clear_decode_graphs()
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for graphed in (False, True):
        with decode_loop(graphed) as last:
            got = {}
            for name, fn in (("2-frame", lambda: model.generate([ids], frames, g32)),
                             ("batch", lambda: model.generate(batch_ids, batch_frames, G16,
                                                              rng=SEED)),
                             ("batch 16", lambda: model.generate(ids16, frames16, G16,
                                                                 rng=SEED)))[:2 + batch16]:
                for counter in INFERENCE_COUNTERS.values():
                    counter.reset()
                out = fn()
                got[name] = (out, {k: c.count for k, c in INFERENCE_COUNTERS.items()},
                             last["logits"])
            ttfts, fulls = [], []
            for _ in range(3):
                ttfts.append(wall(lambda: model.generate([ids], frames, g1))[1])
                fulls.append(wall(lambda: model.generate([ids], frames, g32))[1])
            got["ms_step"] = (statistics.median(fulls) - statistics.median(ttfts)) / 31 * 1e3
        runs[graphed] = got
    entries = gen_mod.decode_graphs()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name in ("2-frame", "batch", "batch 16")[:2 + batch16]:
        (want, want_counts, want_logits), (out, counts, logits) = runs[False][name], runs[True][name]
        diff = (logits - want_logits).abs().max().item()
        log(f"[{tag} graph] {name}: graph tokens {'equal' if out == want else 'DIFFER from'} "
            f"the eager loop's ({[len(r) for r in out]} tokens a row); largest difference of "
            f"the last logits {diff:.3e}; launches graph {counts} eager {want_counts}")
        check(out == want, f"{tag} {name}: the graph's tokens differ from the eager loop's")
        check(counts == want_counts, f"{tag} {name}: the graph's launch counts {counts} are "
              f"not the eager loop's {want_counts}")
        check(counts["K2"] > 0, f"{tag} {name}: no decode step ran {counts}")
    log(f"[{tag} graph] 2-frame bs1 decode: graph {runs[True]['ms_step']:.3f} ms/step, eager "
        f"{runs[False]['ms_step']:.3f} ms/step (medians of 3 generates of 1 and of 32 tokens); "
        f"{len(entries)} graphs, captured in "
        f"{', '.join(f'{e.capture_seconds:.3f}' for e in entries if e.graph is not None)} s, "
        f"{sum(e.replays for e in entries)} replays; peak allocated {peak:.3f} GiB")
    check(entries and all(e.graph is not None and e.replays > 0 for e in entries),
          f"{tag}: every decode graph was captured and replayed")
    gen_mod.clear_decode_graphs()


def phase_failed_capture(model, ids, frames):
    """A host read inside the captured iteration fails the capture: generate
    raises, with no eager fallback."""
    hit = gen_mod._keyword_hit

    def reads_back(window, keyword_ids, keyword_lens):
        out = hit(window, keyword_ids, keyword_lens)
        out.any().item()
        return out

    gen_mod.clear_decode_graphs()
    gen_mod._keyword_hit = reads_back
    try:
        model.generate([ids], frames, GenerationConfig(max_new_tokens=6, temperature=0.0,
                                                       do_sample=False, stop_strings=()))
    except RuntimeError as err:
        raised = f"{type(err).__name__}: {str(err).splitlines()[0][:120]}"
    else:
        raised = None
    finally:
        gen_mod._keyword_hit = hit
    log(f"[graph] a capture with a host read in the step: {raised or 'did NOT raise'}")
    check(raised is not None, "a failed capture did not raise")
    check(gen_mod.decode_graphs()[0].graph is None, "a failed capture left a graph")
    gen_mod.clear_decode_graphs()


# ------------------------------------------------------ speculative decoding

@contextlib.contextmanager
def spec_loop(graphed):
    """Route TEOChat.generate's speculative decode to the replayed CUDA graph
    (True) or to the eager loop on the card (False), through the module's
    private helper."""
    saved = gen_mod.generate_tokens_spec

    def run(*args, **kwargs):
        return gen_mod._generate_tokens_spec(*args, **kwargs, graphed=graphed)[:4]

    gen_mod.generate_tokens_spec = run
    try:
        yield
    finally:
        gen_mod.generate_tokens_spec = saved


def teacher_forced_gaps(model, ids, frames, out):
    """Each emitted token's distance from its position's largest logit, in
    rms units of that position's logits, in one plain prefill of the prompt
    and the emitted tokens (as the stateless path runs it: K1). Greedy
    tokens of a correct path sit at 0 up to the noise between two bf16
    paths (SPEC_GAP_TOL)."""
    cfg = model.cfg
    full = list(ids) + list(out)
    tpf = model.tokens_per_frame
    fused = len(full) + sum(t == IMAGE_TOKEN_INDEX for t in full) * (tpf - 1)
    pad_to = teochat_mod.round_to_bucket(fused, teochat_mod.SEQ_BUCKETS)
    plan = fusion_mod.build_fusion_plan([full], tokens_per_frame=tpf, pad_to=pad_to,
                                        max_length=cfg.tokenizer_model_max_length)
    vision = (model.encode(frames) if frames is not None else
              torch.zeros((1, tpf, cfg.llm.hidden_size), dtype=torch.bfloat16, device="cuda"))
    embeds = teochat_mod.multimodal_embeds(model.params, cfg, plan, vision)
    pos = torch.as_tensor(plan.position_ids, device="cuda")
    mask = torch.as_tensor(plan.attention_mask, device="cuda")
    cache = llama_mod.init_cache(cfg.llm, 1, pad_to + 1, dtype=torch.bfloat16, device="cuda")
    with torch.no_grad():
        logits = gen_mod.backend_forward(model.params["llm"], cfg.llm, embeds, position_ids=pos,
                                         cache=cache, write_slots=torch.where(mask, pos, pad_to),
                                         logits_mode="all")[0]
    n, end = len(out), int(plan.seq_lens[0]) - 1
    rows = logits[end - n:end]  # the positions that predict each emitted token
    tok = torch.as_tensor(out, device="cuda")[:, None]
    gaps = (rows.max(-1).values - rows.gather(1, tok)[:, 0]) / rows.std(-1)
    return gaps.tolist(), rows.argmax(-1).tolist()


def teacher_forced_gaps_e4m3(model, ids, frames, out, cached_from=None):
    """teacher_forced_gaps over an e4m3 KV cache, read as the e4m3 decode
    reads it: the prompt prefilled into an e4m3 cache attending its fresh K/V
    (or, from slot `cached_from` on, attending the e4m3 cache itself, as a
    chunked prefill's pieces and a prefix hit's suffix do), then every
    emitted token but the last fed in one verify block (K2m over the e4m3
    cache, each query up to its own slot). What is left between this and
    the decode that emitted `out` is the order of the sums."""
    cfg = model.cfg
    llm = model.params["llm"]
    tpf = model.tokens_per_frame
    fused = len(ids) + sum(t == IMAGE_TOKEN_INDEX for t in ids) * (tpf - 1)
    pad_to = teochat_mod.round_to_bucket(fused, teochat_mod.SEQ_BUCKETS)
    plan = fusion_mod.build_fusion_plan([list(ids)], tokens_per_frame=tpf, pad_to=pad_to,
                                        max_length=cfg.tokenizer_model_max_length)
    vision = (model.encode(frames) if frames is not None else
              torch.zeros((1, tpf, cfg.llm.hidden_size), dtype=torch.bfloat16, device="cuda"))
    embeds = teochat_mod.multimodal_embeds(model.params, cfg, plan, vision)
    seq, n = int(plan.seq_lens[0]), len(out)
    cache = llama_mod.init_cache(cfg.llm, 1, pad_to + n + 1, dtype=E4M3, device="cuda")
    pos = torch.as_tensor(plan.position_ids, device="cuda")
    mask = torch.as_tensor(plan.attention_mask, device="cuda")
    last = torch.tensor([seq - 1], device="cuda")
    with torch.no_grad():
        if cached_from is None:
            logits0 = llama_mod.llama_forward(
                llm, cfg.llm, embeds, position_ids=pos, cache=cache,
                write_slots=torch.where(mask, pos, pad_to + n), logits_mode="last",
                last_index=last)
        else:
            if cached_from:
                head = pos[:, :cached_from]
                llama_mod.llama_forward(llm, cfg.llm, embeds[:, :cached_from], position_ids=head,
                                        cache=cache, write_slots=head, logits_mode="none")
            piece = torch.arange(cached_from, pad_to, device="cuda")[None]
            logits0 = llama_mod.llama_forward(
                llm, cfg.llm, embeds[:, cached_from:], position_ids=piece, cache=cache,
                write_slots=piece, logits_mode="last", last_index=last - cached_from,
                prefill_start=cached_from, attend_cache=True)
        rows = [logits0[0]]
        if n > 1:
            blk = seq + torch.arange(n - 1, device="cuda")[None]
            emb = llama_mod.embed_tokens(llm, torch.as_tensor(out[:-1], device="cuda")[None],
                                         dtype=torch.bfloat16)
            rows.append(llama_mod.llama_forward(llm, cfg.llm, emb, position_ids=blk,
                                                cache=cache, write_slots=blk, logits_mode="all",
                                                spec_verify=True)[0])
    rows = torch.cat(rows)
    tok = torch.as_tensor(out, device="cuda")[:, None]
    return ((rows.max(-1).values - rows.gather(1, tok)[:, 0]) / rows.std(-1)).tolist()


def _first_difference(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def phase_spec(model, tokenizer, processor, ids, frames, tag, ks=(4, 8),
               sweep=(0, 1, 4, 7, 8)):
    """Prompt-lookup speculative decoding on this model, through
    TEOChat.generate and generate_tokens_spec: the replayed graph against
    the eager loop and greedy correctness against a teacher-forced prefill
    at each k of `ks`, a capture with a planted host read, the oracle
    workloads, a sampled run, and ms a verify iteration at each k of
    `sweep` (0: the plain step; see the module's docstring, phase 7 and 11)."""
    cfg = model.cfg
    n_layers = cfg.llm.num_layers
    batch_ids, batch_frames = ragged_batch(tokenizer, processor)
    gen_mod.clear_decode_graphs()
    torch.cuda.reset_peak_memory_stats()

    def greedy(k, n=16, stops=("</s>",)):
        return GenerationConfig(max_new_tokens=n, temperature=0.0, do_sample=False,
                                stop_strings=stops, speculative_k=k)

    # the replayed graph against the eager loop: tokens, counters, launches
    for k in ks:
        for name, args in (("2-frame", ([ids], frames)), ("batch", (batch_ids, batch_frames))):
            runs = {}
            for graphed in (False, True):
                with spec_loop(graphed):
                    out, counts = counted(f"{tag} spec k {k} {name} graphed={graphed}",
                                          lambda: model.generate(*args, greedy(k)))
                runs[graphed] = (out, dict(model.last_spec_stats), counts)
            (want, want_stats, want_counts), (out, stats, counts) = runs[False], runs[True]
            iterations = counts["K2m"] / n_layers
            log(f"[{tag} spec] k {k} {name}: graph tokens "
                f"{'equal' if out == want else 'DIFFER from'} the eager loop's "
                f"({[len(r) for r in out]} a row); stats graph {stats} eager {want_stats}; "
                f"{iterations:g} verify iterations run")
            check(out == want and stats == want_stats,
                  f"{tag} spec k {k} {name}: the graph's tokens or counters differ")
            check(counts == want_counts, f"{tag} spec k {k} {name}: launches {counts} against "
                  f"the eager loop's {want_counts}")
            check(counts["K2m"] % n_layers == 0 and
                  stats["steps"] <= iterations < stats["steps"] + gen_mod.SPEC_CHUNK,
                  f"{tag} spec k {k} {name}: K2m {counts['K2m']} is not {n_layers} a verify "
                  f"iteration over {stats['steps']} steps")
            check(counts["K2"] == 0, f"{tag} spec k {k} {name}: a single-query step ran {counts}")

    # a capture with a host read planted in the iteration raises
    hit = gen_mod._keyword_hit

    def reads_back(window, keyword_ids, keyword_lens):
        out = hit(window, keyword_ids, keyword_lens)
        out.any().item()
        return out

    gen_mod.clear_decode_graphs()
    gen_mod._keyword_hit = reads_back
    try:
        model.generate([ids], frames, greedy(4, 6))
    except RuntimeError as err:
        raised = f"{type(err).__name__}: {str(err).splitlines()[0][:120]}"
    else:
        raised = None
    finally:
        gen_mod._keyword_hit = hit
    log(f"[{tag} spec] a capture with a host read in the verify iteration: "
        f"{raised or 'did NOT raise'}")
    check(raised is not None and gen_mod.decode_graphs()[0].graph is None,
          f"{tag} spec: a failed capture did not raise, or left a graph")
    gen_mod.clear_decode_graphs()

    # greedy correctness at 7B: each emitted token against a teacher-forced prefill
    plain = model.generate([ids], frames, greedy(0, 32, ()))[0]
    for k in ks:
        out = model.generate([ids], frames, greedy(k, 32, ()))[0]
        gaps, argmax = teacher_forced_gaps(model, ids, frames, out)
        worst = max(gaps)
        log(f"[{tag} spec] k {k} greedy, 32 tokens: {model.last_spec_stats}; each token's gap "
            f"to its position's largest logit in a teacher-forced prefill, in rms units of the "
            f"logits: largest {worst:.3e} (bound {SPEC_GAP_TOL}), {sum(g > 0 for g in gaps)} "
            f"of {len(gaps)} not the prefill's argmax; the spec tokens first leave the plain "
            f"greedy tokens at {_first_difference(out, plain)}")
        check(worst <= SPEC_GAP_TOL, f"{tag} spec k {k}: a token {worst} rms below its "
              f"position's largest logit")

    # the oracle workloads: the emitted tokens are the oracle's, and the times
    vision = model.encode(frames)
    table, rows = {}, {}
    for wname, (ptext, rtext) in bench_main._SPEC_WORKLOADS.items():
        wids = [1] + [IMAGE_TOKEN_INDEX, 7] * 2 + bench_main._eo_tokenize(ptext, table)[:123]
        rtoks = bench_main._eo_tokenize(rtext, table)[:64]
        rows[wname] = (wids, np.asarray([rtoks], np.int32))
    stop = gen_mod.StopSpec(keyword_ids=np.zeros((1, 1), np.int32),
                            keyword_lens=np.zeros((1,), np.int32), eos_id=-1)
    spec_k, results = 8, {}

    def oracle_run(wids, oracle, n_new):
        plan = fusion_mod.build_fusion_plan([wids], tokens_per_frame=model.tokens_per_frame,
                                            pad_to=640)
        emb = teochat_mod.multimodal_embeds(model.params, cfg, plan, vision)
        lens, mask, pos = (torch.as_tensor(a, device="cuda")
                           for a in (plan.seq_lens, plan.attention_mask, plan.position_ids))
        return gen_mod.generate_tokens_spec(
            model.params["llm"], cfg.llm, emb, lens, mask, pos, np.asarray([wids], np.int32),
            np.asarray([len(wids)], np.int32), stop, torch.Generator(device="cuda"),
            max_new_tokens=n_new, cache_len=640 + n_new + spec_k + 1, spec_k=spec_k,
            oracle_ids=oracle[:, :n_new])

    for wname, (wids, oracle) in rows.items():
        tokens, n_gen, steps, accepted = oracle_run(wids, oracle, 64)
        steps, accepted = int(steps), int(accepted)
        check(tokens.tolist() == oracle.tolist() and int(n_gen[0]) == 64,
              f"{tag} spec {wname}: the emitted tokens are not the oracle's")
        t_one = statistics.median(wall(lambda: oracle_run(wids, oracle, 1))[1] for _ in range(3))
        t_w = statistics.median(wall(lambda: oracle_run(wids, oracle, 64))[1] for _ in range(3))
        results[wname] = (64 / steps, accepted / (steps * spec_k), 63 / (t_w - t_one))
        log(f"[{tag} spec] oracle {wname} (k {spec_k}, 64 tokens): the oracle's tokens exactly; "
            f"{steps} verify iterations, {accepted} drafts accepted: {64 / steps:.3f} tokens an "
            f"iteration, acceptance {accepted / (steps * spec_k):.3f}; "
            f"{63 / (t_w - t_one):.2f} tok/s (generate of 64 tokens {t_w * 1e3:.2f} ms, of 1 "
            f"{t_one * 1e3:.2f} ms; medians of 3)")

    # a sampled run: the graph and the eager loop draw the same tokens from one seed
    sampled = GenerationConfig(max_new_tokens=16, temperature=0.8, do_sample=True,
                               stop_strings=(), speculative_k=4)
    runs = {}
    for graphed in (False, True):
        with spec_loop(graphed):
            runs[graphed] = (model.generate(batch_ids, batch_frames, sampled, rng=SEED + 5),
                             dict(model.last_spec_stats))
    log(f"[{tag} spec] sampled (t 0.8, k 4, batch of 4): graph "
        f"{'equals' if runs[True] == runs[False] else 'DIFFERS from'} the eager loop "
        f"({runs[True][1]}, {[len(r) for r in runs[True][0]]} tokens a row)")
    check(runs[True] == runs[False], f"{tag} spec: sampled graph and eager loop differ")

    # ms per verify iteration by k beside the plain graphed step (2-frame, bs 1)
    times = {}
    for k in sweep:
        g1, g33 = greedy(k, 1, ()), greedy(k, 33, ())
        model.generate([ids], frames, g33)  # the capture
        t1, tn = [], []
        for _ in range(3):
            t1.append(wall(lambda: model.generate([ids], frames, g1))[1])
            out, sec = wall(lambda: model.generate([ids], frames, g33))
            tn.append(sec)
        steps = model.last_spec_stats["steps"] if k else len(out[0])
        dt = statistics.median(tn) - statistics.median(t1)
        times[k] = (dt / max(steps - 1, 1) * 1e3, (len(out[0]) - 1) / dt, len(out[0]) / steps)
    entries = gen_mod.decode_graphs()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag} spec] 2-frame bs1, 33 tokens (medians of 3 generates of 1 and 33): ms a "
        f"verify iteration, tok/s, tokens an iteration: "
        + "; ".join(f"{'plain step' if k == 0 else f'k {k}'} {ms:.3f} ms, {tok_s:.2f} tok/s, "
                    f"{per:.3f}" for k, (ms, tok_s, per) in times.items())
        + f"; oracle workloads at k {spec_k}: "
        + ", ".join(f"{w} {tok_s:.2f} tok/s ({per:.3f} tokens an iteration, acceptance "
                    f"{acc:.3f}) against plain {times[0][1]:.2f}"
                    for w, (per, acc, tok_s) in results.items())
        + f"; {len(entries)} graphs live, captured in "
        f"{', '.join(f'{e.capture_seconds:.3f}' for e in entries if e.graph is not None)} s; "
        f"peak allocated {peak:.3f} GiB")
    gen_mod.clear_decode_graphs()
    return times, results


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


# ------------------------------------------------------ the fp8 (e4m3) cache

@contextlib.contextmanager
def kv_cache_of(kv_dtype, graphed, caches=None):
    """Route TEOChat.generate's decode over a KV cache in `kv_dtype` (None:
    the model's), replayed from a CUDA graph or eager, through the module's
    private helper; `caches` collects each call's cache GiB by dtype."""
    saved = gen_mod.generate_tokens

    def run(*args, **kwargs):
        tokens, n_gen, state = gen_mod._generate_tokens(*args, **kwargs, graphed=graphed,
                                                        kv_dtype=kv_dtype)
        if caches is not None:
            c = state.cache
            caches[str(c.dtype)] = 2 * c.k.numel() * c.k.element_size() / 2**30
        return tokens, n_gen

    gen_mod.generate_tokens = run
    try:
        yield
    finally:
        gen_mod.generate_tokens = saved


def fp8_batch(tokenizer, processor, n):
    """n rows cycling a 2-frame, a 1-frame and a text prompt: (ids, each
    row's frames or None, the batch's frames)."""
    rows = [(PROMPT_2.replace("<video>", "Image 1: <image> Image 2: <image>"), 2),
            ("Describe the land use in this image: <image>", 1), ("What is a satellite image?", 0)]
    ids, frames = [], []
    for i in range(n):
        prompt, k = rows[i % 3]
        ids.append(tokenizer_image_token(prompt, tokenizer, IMAGE_TOKEN_INDEX))
        frames.append(processor.preprocess(["x"] * k)["pixel_values"] if k else None)
    return ids, frames, np.concatenate([f for f in frames if f is not None], axis=0)


def phase_fp8_generate(model, tokenizer, processor, tag, batches=(1, 32)):
    """generate over an e4m3 KV cache at 7B width (the int8 model's depth,
    or the int4 path's INT4_LAYERS), at each batch
    of `batches` (rows of 2, 1 and 0 frames), 32 greedy tokens: the graph's
    tokens equal the eager loop's, the first token the bf16 cache's (the
    prefill attends the fresh K/V in bf16), every token of the first three
    rows within SPEC_GAP_TOL of its teacher-forced maximum over an e4m3
    cache (teacher_forced_gaps_e4m3), and its gap to the bf16 path's
    teacher-forced maximum and where it first leaves the bf16 cache's
    tokens printed: e4m3 rounds each K and V by up to 2^-4, and random 7B
    weights put near-ties among 32,000 logits, so that gap can pass
    SPEC_GAP_TOL with no fault (read 0.556 on an H100); K2's e4m3 form
    launches and the bf16 one never; ms a step both ways (medians of
    generates of 1 and of 32 tokens: 3 of each in turns e4m3, bf16, e4m3,
    bf16 at batch 1; 2 in turns e4m3, bf16 past it), both caches' GiB and
    the peak. Returns {batch: numbers} and the e4m3 launches."""
    g1 = GenerationConfig(max_new_tokens=1, temperature=0.0, do_sample=False, stop_strings=())
    g32 = GenerationConfig(max_new_tokens=32, temperature=0.0, do_sample=False, stop_strings=())
    out, launches = {}, 0
    for b in batches:
        ids, row_frames, frames = fp8_batch(tokenizer, processor, b)
        gen_mod.clear_decode_graphs()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        caches = {}
        with kv_cache_of(None, True, caches):
            bf16 = model.generate(ids, frames, g32)
        with kv_cache_of(E4M3, False, caches):
            eager = model.generate(ids, frames, g32)

        def graphed():
            with kv_cache_of(E4M3, True, caches):
                return model.generate(ids, frames, g32)

        fp8, counts = counted(f"{tag} fp8 bs{b}", graphed)
        launches += counts["K2 e4m3"]
        check(fp8 == eager, f"{tag} fp8 bs{b}: the graph's tokens differ from the eager loop's")
        check(counts["K2 e4m3"] > 0 and counts["K2"] == 0 and counts["K2m e4m3"] == 0,
              f"{tag} fp8 bs{b}: launches {counts}")
        check([r[0] for r in fp8] == [r[0] for r in bf16],
              f"{tag} fp8 bs{b}: a first token differs from the bf16 cache's")
        worst = worst_bf16 = 0.0
        for r in range(min(b, 3)):
            gaps = teacher_forced_gaps_e4m3(model, ids[r], row_frames[r], fp8[r])
            gaps_bf16, _ = teacher_forced_gaps(model, ids[r], row_frames[r], fp8[r])
            worst, worst_bf16 = max(worst, max(gaps)), max(worst_bf16, max(gaps_bf16))
            log(f"[{tag} fp8 bs{b}] row {r}: {len(fp8[r])} tokens, the graph's equal the eager "
                f"loop's; first difference from the bf16 cache's at "
                f"{_first_difference(fp8[r], bf16[r])}; largest gap to its teacher-forced "
                f"maximum over e4m3 {max(gaps):.3e} rms (bound {SPEC_GAP_TOL}), over the bf16 "
                f"path {max(gaps_bf16):.3e} rms")
        check(worst <= SPEC_GAP_TOL, f"{tag} fp8 bs{b}: a token {worst} rms below its maximum")
        ms, reps = {}, 3 if b == 1 else 2
        for kv in (E4M3, None, E4M3, None)[:4 if b == 1 else 2]:
            with kv_cache_of(kv, True):
                t1 = statistics.median(wall(lambda: model.generate(ids, frames, g1))[1]
                                       for _ in range(reps))
                t32 = statistics.median(wall(lambda: model.generate(ids, frames, g32))[1]
                                        for _ in range(reps))
            ms.setdefault(str(kv or torch.bfloat16), []).append((t32 - t1) / 31 * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        e4m3_ms, bf16_ms = ms[str(E4M3)], ms[str(torch.bfloat16)]
        log(f"[{tag} fp8 bs{b}] {_timing.smi_line()}: ms a step e4m3 "
            f"{', '.join(f'{x:.3f}' for x in e4m3_ms)} against bf16 "
            f"{', '.join(f'{x:.3f}' for x in bf16_ms)} (in turns, e4m3 first; "
            f"{b * 1e3 / statistics.mean(e4m3_ms):.1f} against "
            f"{b * 1e3 / statistics.mean(bf16_ms):.1f} tok/s); caches "
            f"{caches[str(E4M3)]:.3f} GiB e4m3, {caches[str(torch.bfloat16)]:.3f} GiB bf16; peak "
            f"allocated {peak:.3f} GiB (the model, both graph entries' caches, the eager cache)")
        out[b] = {"ms_step_e4m3": e4m3_ms, "ms_step_bf16": bf16_ms, "largest_gap": worst,
                  "largest_gap_bf16_path": worst_bf16,
                  "cache_gib_e4m3": caches[str(E4M3)],
                  "cache_gib_bf16": caches[str(torch.bfloat16)], "peak_gib": peak}
    gen_mod.clear_decode_graphs()
    return out, launches


def phase_logits(model, ids, frames, compare="attention"):
    """Last-position prefill logits of the 2-frame request, kernels against
    plain: `compare` = 'attention' (flash kernel vs plain attention) or
    'int4' (int4 kernels vs plain int4_proj, the attention kernels in both).
    Returns the relative L2."""
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
            logits[impl] = gen_mod.backend_forward(
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
    return rel


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


TRAIN_FRAME_HW = (300, 400)


def train_dataset_dir(path, n: int) -> str:
    """`train_samples(n)` as a local dataset dir that `--data_name` reads
    through `datasets.load_dataset(dir, split="train")`: train.parquet (JSON
    lines would have the timestamps parsed as dates), each frame a random
    uint8 PNG file by absolute path."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from PIL import Image

    os.makedirs(path)
    rs = np.random.RandomState(SEED + 11)
    rows = train_samples(n)
    for row in rows:
        row["video"] = [os.path.abspath(os.path.join(path, name)) for name in row["video"]]
        for f in row["video"]:
            Image.fromarray(rs.randint(0, 256, (*TRAIN_FRAME_HW, 3), dtype=np.uint8)).save(f)
    pq.write_table(pa.Table.from_pylist(rows), os.path.join(path, "train.parquet"))
    return path


def recipe_argv(ckpt_path, data_dir, out_dir, cache_dir, **over):
    """scripts/train_teochat.sh's flags over the checkpoint (`--bits 8`,
    LoRA r 128 / alpha 256, the projector's lr 2e-5, warmup 0.03, batch 4,
    grouped by modality) with accumulation 2, a save every 2 steps, a
    prefetch thread 2 batches deep, every step logged; `over` replaces or
    adds flags (`lora_enable="False"`)."""
    flags = {
        "model_name_or_path": ckpt_path, "version": "v1", "data_name": data_dir,
        "data_split": "train", "data_cache_dir": cache_dir, "prompt_strategy": "interleave",
        "chronological_prefix": "True", "bits": "8", "lora_enable": "True", "lora_r": "128",
        "lora_alpha": "256", "mm_projector_lr": "2e-5", "learning_rate": "2e-4",
        "warmup_ratio": "0.03", "per_device_train_batch_size": "4",
        "gradient_accumulation_steps": "2", "num_train_epochs": "2", "save_steps": "2",
        "save_total_limit": "10", "group_by_modality_length": "True", "output_dir": out_dir,
        "mm_use_im_patch_token": "False", "dataloader_num_workers": "2", "logging_steps": "1",
        "report_to": "none", "seed": str(SEED), "max_steps": "3",
    }
    flags.update({k: str(v) for k, v in over.items()})
    return [a for k, v in flags.items() for a in (f"--{k}", v)]


def _ckpt_dirs(out_dir):
    """{checkpoint-N: whether it holds an optimizer state}."""
    return {n: os.path.isdir(os.path.join(out_dir, n, "opt_state"))
            for n in sorted(os.listdir(out_dir)) if n.startswith("checkpoint-")}


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files)


def _log_history(tag, history, accum):
    for h in history:
        save = f"; its periodic save {h['save_seconds']:.2f} s" if "save_seconds" in h else ""
        log(f"[{tag}] step {h['step']}: loss {h['loss']:.6f}, {h['seconds']:.3f} s, "
            f"{h['tokens'] / h['seconds']:.1f} tokens/s ({h['tokens']} valid of "
            f"{h['padded_tokens']} padded tokens, {accum} micro-batches){save}")


def _round_trip(ckpt, copy_dir, device="cuda"):
    """checkpoint-N loaded onto the card, saved from it and read again: every
    leaf of the params and the optimizer state bit for bit. Returns the
    seconds of the load, of the save and of the second read with the
    comparison, the bytes and the leaves compared."""
    from teochat_torch.checkpoint import orbax_io
    from teochat_torch.utils import tree_map

    def to_card(tree):
        return tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, tree)

    (params, cfg, opt), load_s = wall(lambda: tuple(map(to_card, orbax_io.load_checkpoint(
        ckpt, restore_opt=True))))
    check(opt is not None, f"{ckpt} has no optimizer state")
    _, save_s = wall(lambda: orbax_io.save_checkpoint(copy_dir, params, cfg, opt_state=opt))
    nbytes = _dir_bytes(copy_dir)

    def compare():
        params2, cfg2, opt2 = orbax_io.load_checkpoint(copy_dir, restore_opt=True)
        check(cfg2 == cfg, "round trip: the config")
        n = 0
        for a_tree, b_tree in ((params, params2), (opt, opt2)):
            a, b = dict(tree_leaves_with_path(a_tree)), dict(tree_leaves_with_path(b_tree))
            check(sorted(a) == sorted(b), "round trip: the leaves")
            for path, x in a.items():
                y = b[path]
                if isinstance(x, torch.Tensor):
                    y = y.to(device)
                    check(x.dtype == y.dtype and x.shape == y.shape and torch.equal(
                        x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)),
                        f"round trip: {path} not bitwise")
                else:
                    check(x == y, f"round trip: {path} {x} != {y}")
                n += 1
        return n

    n, load2_s = wall(compare)
    return load_s, save_s, load2_s, nbytes, n


def phase_train_cli(root, ckpt_path, model):
    """The recipe through `teochat_torch.train.cli.main` over the int8
    TEOChat-7B checkpoint: (a) 3 optimizer steps of LoRA r128 over the int8
    backbone (accumulation 2, remat, a save every 2 steps), the K4 launches
    counted; every adapter and projector leaf moved; checkpoint-2 holds an
    optimizer state and the final save checkpoint-3 none (F7); (b)
    checkpoint-2 loaded, saved and loaded again, bitwise; (c) a second run
    resumes from checkpoint-2 (checkpoint-3 removed) to step 3; (d) 2 steps
    of the projector alone, in which nothing else moves, whose final save
    replaces its periodic one at step 2 without its optimizer state (F7).
    Returns the K4 launches of (a) and the phase's numbers."""
    from teochat_torch.train import cli as train_cli

    os.environ.setdefault("HF_DATASETS_OFFLINE", "1")  # the dataset dir is local
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    smi = _timing.smi_line()
    t0 = time.perf_counter()
    data = train_dataset_dir(os.path.join(root, "train-data"), N_TRAIN_SAMPLES)
    out = os.path.join(root, "train-out")
    cache = os.path.join(root, "datasets-cache")
    argv = recipe_argv(ckpt_path, data, out, cache)
    layers = model.cfg.llm.num_layers
    accum, steps = 2, 3

    # (a)
    history = []
    for counter in (flash_mod.FWD_RES_LAUNCHES, flash_mod.BWD_DKV_LAUNCHES,
                    flash_mod.BWD_DQ_LAUNCHES):
        counter.reset()
    gc.collect()
    before_alloc = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, sec = wall(lambda: train_cli.main(argv, history=history))
    counts = _k4_counts()
    peak = (torch.cuda.max_memory_allocated() - before_alloc) / 2**30
    check(len(history) == steps and state.step == steps * accum, "three optimizer steps")
    check(all(np.isfinite(h["loss"]) and h["loss"] > 0 for h in history),
          "training losses finite and positive (the labels are not all masked)")
    _log_history("train cli", history, accum)
    steady = history[1:]
    s_step = sum(h["seconds"] for h in steady) / len(steady)
    tok_s = sum(h["tokens"] for h in steady) / sum(h["seconds"] for h in steady)
    first_s = history[0]["seconds"]
    load_s = sec - sum(h["seconds"] + h.get("save_seconds", 0) for h in history)
    log(f"[train cli] cli.main (TEOChat-7B int8 checkpoint + LoRA r128, batch 4, accumulation "
        f"{accum}): {sec:.2f} s for {steps} steps, of which the load, set-up and final save "
        f"{load_s:.2f} s and step 1 {first_s:.3f} s; steps 2-3: {s_step:.3f} s/step, "
        f"{tok_s:.1f} valid tokens/s; peak allocated {peak:.3f} GiB above the "
        f"{before_alloc / 2**30:.3f} GiB held before; {smi}")
    log(f"[train cli] kernel launches during cli.main: K4a {counts['fwd']}, K4b {counts['dkv']}, "
        f"K4c {counts['dq']} over {steps * accum} micro-steps of {layers} layers")
    check(min(counts.values()) >= layers * steps * accum, f"K4 launches {counts}")
    dev = model.params["llm"]["embed_tokens"]["embedding"].device
    init_lora = add_lora_params(torch.Generator(device=dev).manual_seed(SEED),
                                model.params["llm"], rank=128, alpha=256.0)
    want = dict(tree_leaves_with_path(partition_params({"llm": init_lora},
                                                       lora_trainable_filter)[0]))
    got = dict(tree_leaves_with_path(partition_params({"llm": state.params["llm"]},
                                                      lora_trainable_filter)[0]))
    check(sorted(got) == sorted(want) and len(got) == 14, "LoRA leaves")
    for path, x in got.items():
        check(not torch.equal(x, want[path]), f"{path} did not change")
    before_proj = dict(tree_leaves_with_path(model.params["projector"]))
    for path, x in tree_leaves_with_path(state.params["projector"]):
        check(not torch.equal(x, before_proj[path].float()), f"projector/{path} did not change")
    del init_lora, want, got, state
    gc.collect()
    torch.cuda.empty_cache()
    dirs = _ckpt_dirs(out)
    check(dirs == {"checkpoint-2": True, "checkpoint-3": False},
          f"checkpoints {dirs}: checkpoint-2 with its optimizer state, the final save without")
    ckpt2 = os.path.join(out, "checkpoint-2")
    save_gb = _dir_bytes(ckpt2) / 1e9
    save_s = history[1]["save_seconds"]
    log(f"[train cli] checkpoint-2 (params and optimizer state): {save_gb:.3f} GB written in "
        f"{save_s:.2f} s ({save_gb / save_s:.3f} GB/s); the final save checkpoint-3 "
        f"{_dir_bytes(os.path.join(out, 'checkpoint-3')) / 1e9:.3f} GB, no optimizer state (F7)")
    shutil.rmtree(os.path.join(out, "checkpoint-3"))
    marks = {"(a)": time.perf_counter()}

    # (b)
    copy_dir = os.path.join(root, "train-round-trip")
    load1, save_rt, load2, nbytes, n_leaves = _round_trip(ckpt2, copy_dir)
    shutil.rmtree(copy_dir)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train cli] checkpoint-2 loaded onto the card, saved, read back, bitwise over "
        f"{n_leaves} leaves: the load {load1:.2f} s ({nbytes / 1e9 / load1:.3f} GB/s, a warm "
        f"read), the save {save_rt:.2f} s ({nbytes / 1e9:.3f} GB, {nbytes / 1e9 / save_rt:.3f} "
        f"GB/s), the second read with the comparison {load2:.2f} s; {smi}")
    marks["(b)"] = time.perf_counter()

    # (c)
    history2 = []
    torch.cuda.reset_peak_memory_stats()
    state, resume_s = wall(lambda: train_cli.main(argv, history=history2))
    resume_peak = (torch.cuda.max_memory_allocated() - before_alloc) / 2**30
    check([h["step"] for h in history2] == [3] and state.step == 2 + accum,
          f"the resume from checkpoint-2 to step 3: {[h['step'] for h in history2]}")
    check(np.isfinite(history2[0]["loss"]), "the resumed step's loss")
    _log_history("train cli resume", history2, accum)
    log(f"[train cli] resume (the builder's load, checkpoint-2 restored, step 3, the final "
        f"save): {resume_s:.2f} s; peak allocated {resume_peak:.3f} GiB above the "
        f"{before_alloc / 2**30:.3f} GiB held before; {smi}")
    check(_ckpt_dirs(out) == {"checkpoint-2": True, "checkpoint-3": False}, "resumed checkpoints")
    del state
    shutil.rmtree(out)
    gc.collect()
    torch.cuda.empty_cache()
    marks["(c)"] = time.perf_counter()

    # (d)
    out_p = os.path.join(root, "train-projector")
    history3 = []
    state, proj_s = wall(lambda: train_cli.main(recipe_argv(
        ckpt_path, data, out_p, cache, lora_enable="False", tune_mm_mlp_adapter="True",
        max_steps=2), history=history3))
    check(len(history3) == 2 and all(np.isfinite(h["loss"]) for h in history3),
          "two projector-only steps")
    _log_history("train cli projector", history3, accum)
    base = dict(tree_leaves_with_path(model.params))
    moved = []
    for path, x in tree_leaves_with_path(state.params):
        if path.startswith("projector/"):
            check(x.dtype == torch.float32 and not torch.equal(x, base[path].float()),
                  f"{path} did not move")
            moved.append(path)
        else:
            check(torch.equal(x, base[path]), f"{path} moved in a projector-only run")
    check(len(moved) == 4 and sorted(base) == sorted(p for p, _ in tree_leaves_with_path(
        state.params)), "projector-only: the trained leaves")
    check(_ckpt_dirs(out_p) == {"checkpoint-2": False},
          "projector-only: the final save at step 2 replaced the periodic one without its "
          "optimizer state (F7)")
    log(f"[train cli] projector only (--lora_enable False --tune_mm_mlp_adapter True): "
        f"{proj_s:.2f} s for 2 steps, only the 4 projector leaves moved; checkpoint-2 "
        f"holds no optimizer state after the final save (F7)")
    del state
    shutil.rmtree(out_p)
    gc.collect()
    torch.cuda.empty_cache()
    marks["(d)"] = time.perf_counter()
    phase_s = time.perf_counter() - t0
    ends = list(marks.values())
    parts = {name: end - start for name, start, end in zip(marks, [t0] + ends, ends)}
    log(f"[train cli] the phase took {phase_s:.1f} s: "
        + ", ".join(f"{name} {v:.1f}" for name, v in parts.items()))
    return counts, {
        "cli_s": sec, "load_and_setup_s": load_s, "step_s": s_step, "tokens_per_s": tok_s,
        "peak_gib": peak, "save_s": save_s, "save_gb": save_gb, "load_s": load1,
        "resume_s": resume_s, "resume_peak_gib": resume_peak, "projector_only_s": proj_s,
        "phase_s": phase_s, "part_s": parts, "smi": smi}


def _lora_projections(llm):
    """The projection dicts that carry adapters: LLaMA's attn / mlp groups,
    or MPT's four flat projections."""
    layers = llm["layers"]
    if mpt_mod.is_mpt_params(llm):
        return [layers[name] for name in MPT_TARGET_NAMES]
    return [proj for group in LORA_TARGET_GROUPS for proj in layers[group].values()]


def parity_batch(cfg, params, tokenizer, processor, gen, rows=4):
    """The parity phase's inputs: params with fp32 LoRA (B drawn nonzero from
    `gen`, so every adapter gets a gradient) and projector masters, their
    trainable leaves by path, and one batch of `rows` `train_samples`."""
    dev = gen_mod.embedding_table(params["llm"]).device
    llm = add_lora_params(gen, params["llm"], rank=128, alpha=256.0)
    for proj in _lora_projections(llm):
        proj["lora_b"] = torch.randn(proj["lora_b"].shape, generator=gen, device=dev) * 1e-3
    params = fp32_masters({**params, "llm": llm}, lora_trainable_filter)
    module = make_supervised_data_module(
        tokenizer, DataArguments(image_processor=processor),
        tokens_per_frame=cfg.vision.num_patches, max_length=cfg.tokenizer_model_max_length,
        dataset=train_samples(rows))
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


def phase_train_parity(cfg, params, tokenizer, processor, gen, rows=4, tag="train parity"):
    """One micro-step at full width, kernels vs plain attention, LoRA B
    nonzero; returns the numbers it logs."""
    params, leaves, plan, pixels = parity_batch(cfg, params, tokenizer, processor, gen, rows)
    got = micro_step(cfg, params, leaves, plan, pixels, "auto")
    want = micro_step(cfg, params, leaves, plan, pixels, "plain")
    check(np.isfinite(got[0]) and all(torch.isfinite(g).all().item() for g in got[1]),
          "parity finite")
    loss_rel, total, rels = compare_steps(leaves, got, want)
    worst_path = max(rels, key=rels.get)
    log(f"[{tag}] B={plan.labels.shape[0]} S={plan.labels.shape[1]} one micro-step, "
        f"kernels vs plain attention: loss {got[0]:.6f} vs {want[0]:.6f}, rel diff "
        f"{loss_rel:.3e} (bound {TRAIN_LOSS_REL_BOUND}); gradients rel L2 {total:.3e} over all "
        f"{len(rels)} trainable leaves, worst leaf {worst_path} {rels[worst_path]:.3e} "
        f"(bound {TRAIN_GRAD_REL_L2_BOUND})")
    check(loss_rel <= TRAIN_LOSS_REL_BOUND, f"loss rel diff {loss_rel}")
    check(rels[worst_path] <= TRAIN_GRAD_REL_L2_BOUND, f"gradient rel L2 {rels[worst_path]}")
    return {"loss_rel_diff": loss_rel, "grads_rel_l2": total, "worst_leaf": worst_path,
            "worst_leaf_rel_l2": rels[worst_path]}


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
    """The int4 inference path at full width, INT4_LAYERS deep, then its
    logits check."""
    cfg = TEOChatConfig()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, num_layers=INT4_LAYERS))
    torch.cuda.reset_peak_memory_stats()
    params, init_s = wall(lambda: init_teochat(cfg, gen, "cuda", torch.bfloat16, quant="int4"))
    log(f"[int4] init TEOChat-7B's width int4, {INT4_LAYERS} of 32 layers (fused q|k|v and "
        f"gate|up, int4 lm_head; random, seed {SEED}): {init_s:.2f} s, allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB, "
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
    phase_decode_graph(model, tokenizer, processor, ids, frames, "int4")
    phase_failed_capture(model, ids, frames)
    # the verify iteration's ms at k 4 and 8 beside the plain step (k 1 and 7
    # were cut for phase 22's time)
    phase_spec(model, tokenizer, processor, ids, frames, "int4", sweep=(0, 4, 8))
    fp8 = phase_fp8_generate(model, tokenizer, processor, "int4")
    phase_logits(model, ids, frames, compare="int4")
    k3a_counts = phase_k3a_path(cfg, gen, tokenizer, processor)
    return counts, k3a_counts, fp8


# --------------------------------------------------- checkpoint -> eval path

CKPT_LAYERS_PER_SHARD = 4
CKPT_TOWER_PREFIX = "model.image_tower.image_tower.vision_model."
# the loader's peak on the card during an 8-bit load, above what it leaves
# allocated, must stay below this: one chunk of 8 layers of gate or up,
# fp16 in, its fp32 working copy and its int8 result, is ~2.5 GB
CKPT_LOAD_HEADROOM = 3 * 2**30
EVAL_QUESTION = ("This is a sequence of satellite images taken at different times: <video> "
                 "Which class does this sequence of images belong to? Answer with one of "
                 "airport, crop field, dam, factory or power station.")
EVAL_FRAME_SIZES = ((300, 400), (256, 320), (400, 300), (333, 250))


def checkpoint_tokenizer(path, vocab_size):
    """A word-level tokenizer.json of `vocab_size` tokens: the specials, the
    words of the smoke's prompts, then filler words."""
    import re

    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    from teochat_torch.conversation import conv_templates

    def split(*texts):
        return set(re.findall(r"\w+|[^\w\s]+", " ".join(texts))) - {"<", ">", "</"}

    words = sorted(split(PROMPT_2, PROMPT_4, EVAL_QUESTION, "Image 1 2 3 4"))
    # then the training conversations' words and the v1 template's, so that
    # the labels of `train_samples` are not masked for an unknown token
    v1 = conv_templates["v1"]
    words += sorted(split(v1.system, *v1.roles, "in chronological order",
                          *(t for qa in TRAIN_QA for t in qa)) - set(words))
    vocab = {w: i for i, w in enumerate(["<unk>", "<s>", "</s>"] + words)}
    for i in range(len(vocab), vocab_size):
        vocab[f"w{i}"] = i
    tok = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<s>",
                   "eos_token": "</s>", "unk_token": "<unk>"}, f)


def _hf_encoder(cfg, gen):
    """The tower and projector of `init_encoder`'s draw, in fp16, under the
    names a merged TEOChat checkpoint gives them, on the host."""
    enc = init_encoder(cfg, gen, "cuda", torch.float16)
    v, p, d, ps = enc["vision"], CKPT_TOWER_PREFIX, cfg.vision.hidden_size, cfg.vision.patch_size
    sd = {
        p + "embeddings.patch_embedding.weight": v["patch_embedding"]["kernel"].t().reshape(d, 3, ps, ps),
        p + "embeddings.class_embedding": v["class_embedding"],
        p + "embeddings.position_embedding.weight": v["position_embedding"],
    }
    for ours, hf in (("pre_layernorm", "pre_layrnorm"), ("post_layernorm", "post_layernorm")):
        sd[p + hf + ".weight"], sd[p + hf + ".bias"] = v[ours]["scale"], v[ours]["bias"]
    dense = {("attn", "q"): "self_attn.q_proj", ("attn", "k"): "self_attn.k_proj",
             ("attn", "v"): "self_attn.v_proj", ("attn", "out"): "self_attn.out_proj",
             ("mlp", "fc1"): "mlp.fc1", ("mlp", "fc2"): "mlp.fc2"}
    for i in range(cfg.vision.num_layers):
        e = p + f"encoder.layers.{i}."
        for (group, name), hf in dense.items():
            leaf = v["layers"][group][name]
            sd[e + hf + ".weight"], sd[e + hf + ".bias"] = leaf["kernel"][i].t(), leaf["bias"][i]
        for ours, hf in (("ln1", "layer_norm1"), ("ln2", "layer_norm2")):
            sd[e + hf + ".weight"] = v["layers"][ours]["scale"][i]
            sd[e + hf + ".bias"] = v["layers"][ours]["bias"][i]
    for j, layer in enumerate(enc["projector"]["layers"]):
        sd[f"model.mm_projector.{2 * j}.weight"] = layer["kernel"].t()
        sd[f"model.mm_projector.{2 * j}.bias"] = layer["bias"]
    return {k: t.to(torch.float16).contiguous().cpu() for k, t in sd.items()}


def write_teochat_checkpoint(path, cfg, gen):
    """A TEOChat checkpoint in the published merged layout at `path`:
    config.json, fp16 `pytorch_model-0000k-of-0000n.bin` shards of
    CKPT_LAYERS_PER_SHARD decoder layers each (the embedding in the first,
    the final norm and lm_head in the last), the tower and projector in a
    shard of their own, and a word-level tokenizer. Weights are drawn on
    the card from `gen` (the decoder's N(0, 0.02), norms 1; the encoder as
    `init_encoder` draws it) and saved from the host one shard at a time.
    Returns (bytes written, {sample name: its fp16 HF weight on the host})."""
    llm = cfg.llm
    d, inter, L, kv = llm.hidden_size, llm.intermediate_size, llm.num_layers, llm.num_kv_heads * llm.head_dim
    os.makedirs(path, exist_ok=True)
    hf = {
        "architectures": ["LlavaLlamaForCausalLM"], "model_type": "llava", "torch_dtype": "float16",
        "vocab_size": llm.vocab_size, "hidden_size": d, "intermediate_size": inter,
        "num_hidden_layers": L, "num_attention_heads": llm.num_heads,
        "num_key_value_heads": llm.num_kv_heads, "rms_norm_eps": llm.rms_norm_eps,
        "max_position_embeddings": llm.max_position_embeddings, "rope_theta": llm.rope_theta,
        "bos_token_id": 1, "eos_token_id": 2, "pad_token_id": 0,
        "mm_image_tower": "LanguageBind/LanguageBind_Image", "mm_projector_type": "mlp2x_gelu",
        "mm_hidden_size": cfg.vision.hidden_size, "mm_vision_select_layer": -2,
        "mm_vision_select_feature": "patch", "mm_use_im_patch_token": False,
        "mm_use_im_start_end": False, "image_aspect_ratio": "pad",
    }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f, indent=2)
    checkpoint_tokenizer(path, llm.vocab_size)

    def normal(*shape):
        return (torch.randn(shape, generator=gen, device="cuda") * 0.02).to(torch.float16).cpu()

    def ones(n):
        return torch.ones(n, dtype=torch.float16)

    starts = list(range(0, L, CKPT_LAYERS_PER_SHARD))
    n_shards, nbytes, samples = len(starts) + 1, 0, {}

    def save(k, shard):
        nonlocal nbytes
        name = os.path.join(path, f"pytorch_model-{k:05d}-of-{n_shards:05d}.bin")
        torch.save(shard, name)
        nbytes += os.path.getsize(name)

    for k, start in enumerate(starts, 1):
        shard = {"model.embed_tokens.weight": normal(llm.vocab_size, d)} if start == 0 else {}
        for i in range(start, min(start + CKPT_LAYERS_PER_SHARD, L)):
            p = f"model.layers.{i}."
            for name, shape in (("self_attn.q_proj", (d, d)), ("self_attn.k_proj", (kv, d)),
                                ("self_attn.v_proj", (kv, d)), ("self_attn.o_proj", (d, d)),
                                ("mlp.gate_proj", (inter, d)), ("mlp.up_proj", (inter, d)),
                                ("mlp.down_proj", (d, inter))):
                shard[p + name + ".weight"] = normal(*shape)
            shard[p + "input_layernorm.weight"] = ones(d)
            shard[p + "post_attention_layernorm.weight"] = ones(d)
        if start + CKPT_LAYERS_PER_SHARD >= L:
            shard["model.norm.weight"], shard["lm_head.weight"] = ones(d), normal(llm.vocab_size, d)
        for key in ("model.layers.0.self_attn.q_proj.weight",
                    f"model.layers.{L - 1}.mlp.down_proj.weight", "lm_head.weight"):
            if key in shard:
                samples[key] = shard[key]
        save(k, shard)
        del shard
    save(n_shards, _hf_encoder(cfg, gen))
    return nbytes, samples


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in tree_leaves_with_path(tree))


def _peak_rss_gib() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20  # KiB on Linux


def check_int8_samples(model, samples):
    """Sampled int8 projections, dequantized, against the checkpoint's fp16
    weights: each within half a quantization step of its column (and the
    fp32 rounding of q * scale)."""
    llm, last = model.params["llm"], model.cfg.llm.num_layers - 1
    leaves = {
        "model.layers.0.self_attn.q_proj.weight": layer_index(llm["layers"]["attn"]["q"], 0),
        f"model.layers.{last}.mlp.down_proj.weight": layer_index(llm["layers"]["mlp"]["down"], last),
        "lm_head.weight": llm["lm_head"],
    }
    worst = 0.0
    for key, leaf in leaves.items():
        want = samples[key].to(leaf["scale"].device).float().t()
        err = (quant_mod.dequantize_kernel(leaf) - want).abs() / (leaf["scale"][None, :] / 2)
        worst = max(worst, err.max().item())
    log(f"[checkpoint] {len(leaves)} sampled int8 projections dequantized against the "
        f"checkpoint's fp16 weights: largest error {worst:.6f} of half a quantization step")
    check(worst <= 1 + 1e-3, f"int8 projections off the checkpoint's weights ({worst})")


def eval_dataset(seed):
    """4 TEOChatlas-style classification examples of 2-4 seeded uint8 frames
    of non-square sizes (so that the resize and the crop both work)."""
    rs = np.random.RandomState(seed)
    truths = ("airport", "crop field", "dam", "power station")
    out = []
    for i, (n_frames, truth) in enumerate(zip((2, 3, 4, 2), truths)):
        frames = [rs.randint(0, 256, (*EVAL_FRAME_SIZES[(i + j) % 4], 3), dtype=np.uint8)
                  for j in range(n_frames)]
        out.append({
            "conversations": [{"from": "human", "value": EVAL_QUESTION},
                              {"from": "gpt", "value": truth}],
            "video": frames,
            "timestamp": [f"201{j + 5}-0{i + 1}-1{j}" for j in range(n_frames)][::-1],
            "task": "classification",
        })
    return out


def phase_checkpoint_eval(gen, root):
    """Write a TEOChat-7B checkpoint, load it with load_8bit through the eval
    driver's own entry, and evaluate 4 examples through `eval()`. Returns
    (the loaded model, its tokenizer, its image processor, the eval's launch
    counts)."""
    from teochat_torch import native
    from teochat_torch.eval import eval as eval_mod

    cfg = TEOChatConfig()
    path = os.path.join(root, "TEOChat-7B")
    (nbytes, samples), sec = wall(lambda: write_teochat_checkpoint(path, cfg, gen))
    log(f"[checkpoint] wrote a TEOChat-7B checkpoint ({cfg.llm.num_layers} decoder layers at "
        f"width {cfg.llm.hidden_size}, the ViT-L/14 tower and the projector; fp16 .bin shards of "
        f"{CKPT_LAYERS_PER_SHARD} layers; random, seed {SEED}): {nbytes} bytes in {sec:.2f} s "
        f"({nbytes / sec / 1e9:.3f} GB/s)")

    gc.collect()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rss_before = _peak_rss_gib()
    (tokenizer, model, processor), load_s = wall(lambda: eval_mod.load_model(path, load_8bit=True))
    tree = _tree_bytes(model.params)
    peak = torch.cuda.max_memory_allocated() - before
    log(f"[checkpoint] eval.load_model(load_8bit=True): {load_s:.2f} s; the process's peak RSS "
        f"{_peak_rss_gib():.3f} GiB ({rss_before:.3f} GiB before the load); card: loaded tree {tree} bytes "
        f"({tree / 2**30:.3f} GiB), peak during the load {peak / 2**30:.3f} GiB above the "
        f"{before / 2**30:.3f} GiB held before; tokenizer {type(tokenizer).__name__} of "
        f"{len(tokenizer)} tokens")
    check(peak < tree + CKPT_LOAD_HEADROOM,
          f"the load's peak {peak} is not below the tree {tree} + 3 GiB")
    check(model.params["llm"]["layers"]["attn"]["q"]["kernel"].dtype == torch.int8, "int8 decoder")
    check_int8_samples(model, samples)
    del samples

    check(native.available(), "the native preprocessing library did not build or load")
    dataset = eval_dataset(SEED)
    frames = dataset[2]["video"]
    pixels = processor.preprocess(frames)["pixel_values"]
    check(pixels.shape == (len(frames), 3, cfg.vision.image_size, cfg.vision.image_size)
          and np.isfinite(pixels).all(), "preprocessed frames")
    times = [wall(lambda: processor.preprocess(frames), "cpu")[1] for _ in range(5)]
    log(f"[checkpoint] native ImageProcessor: {statistics.median(times) / len(frames) * 1e3:.3f} "
        f"ms a frame ({len(frames)} uint8 frames of {[f.shape[:2] for f in frames]}, median of 5)")

    # random weights answer no class name, so the metrics would be {}: the
    # first example's truth is set to its greedy answer (run_inference, as
    # eval() runs it), so that it alone is known to hit and the metrics,
    # first and cached, are {"<task>_accuracy": 0.25} unless another hits too
    first = run_inference(dataset[:1], model, tokenizer, processor, "interleave", True, "v1",
                          0.0, 32, dataset_name="fmow_high_res", progress=False)[0]
    dataset[0]["conversations"][1]["value"] = first["response"]
    out_dir = os.path.join(root, "eval")
    kwargs = dict(model_path=path, out_dir=out_dir, temperature=0.0, max_new_tokens=32)
    metrics, counts = counted("checkpoint eval", lambda: wall(lambda: eval_mod.eval(
        "fmow_high_res", dataset=dataset, model_bundle=(tokenizer, model, processor), **kwargs)))
    metrics, sec = metrics
    sec_b1 = sec / len(dataset)
    with open(os.path.join(out_dir, "fmow_high_res",
                           "TEOChat-7B_prompt_strategy_interleave_chronological_prefix_True.json")) as f:
        outputs = json.load(f)
    steps = counts["K2"] // cfg.llm.num_layers
    log(f"[checkpoint] eval('fmow_high_res') on {len(dataset)} examples of 2-4 frames: "
        f"{sec:.3f} s, {sec_b1:.3f} s an example; {steps + len(dataset)} tokens "
        f"generated ({len(dataset)} prefills, then {steps} decode steps: K2 launches / layers); "
        f"metrics {metrics}; responses {[o['response'][:40] for o in outputs]}")
    check(len(outputs) == len(dataset) and all(isinstance(o["response"], str) for o in outputs),
          "eval outputs")
    check(outputs[0]["response"] == first["response"],
          "eval()'s first answer is not the greedy answer run before it")
    want = classification_metrics(outputs, dataset_name="fmow_high_res")
    check(metrics == want and len(metrics) == 1
          and next(iter(metrics.values())) >= 1 / len(dataset), f"eval metrics {metrics}")
    check(all(counts[k] > 0 for k in ("K1", "K2", "K5")), f"eval launches {counts}")
    check(counts["K5"] % (cfg.vision.num_layers - 1) == 0, f"K5 per encode {counts}")

    (again, sec), cached = counted("checkpoint eval cached", lambda: wall(lambda: eval_mod.eval(
        "fmow_high_res", dataset=None, model_bundle=None, **kwargs)))
    log(f"[checkpoint] the second eval() on the same out_dir, with no model: {sec:.3f} s, "
        f"metrics {again}")
    check(again == metrics and not any(cached.values()), "the cached eval")
    entry = {"load_s": load_s, "load_peak_gib": peak / 2**30,
             "batched": _eval_batched(path, root, dataset, (tokenizer, model, processor),
                                      outputs, sec_b1=sec_b1),
             "preprocess": _device_preprocess(processor)}
    return model, tokenizer, processor, counts, entry


def _eval_batched(path, root, dataset, bundle, outputs_b1, sec_b1):
    """eval() of the same examples at batch_size 4, the split read through a
    stand-in `datasets.load_dataset` (no network: it records its arguments
    and hands back the examples): its answers beside batch 1's, s an
    example both ways, K1, K2 and K5 launching. (Four examples: batch 8
    would run the same single batch.)"""
    from teochat_torch.eval import eval as eval_mod

    calls = []
    stand_in = types.ModuleType("datasets")
    stand_in.load_dataset = lambda *a, **k: calls.append((a, k)) or dataset
    saved = sys.modules.get("datasets")
    sys.modules["datasets"] = stand_in
    out_dir = os.path.join(root, "eval_b4")
    try:
        (metrics, sec), counts = counted("checkpoint eval batch 4", lambda: wall(
            lambda: eval_mod.eval("fmow_high_res", model_path=path, out_dir=out_dir,
                                  model_bundle=bundle, batch_size=4, temperature=0.0,
                                  max_new_tokens=32)))
    finally:
        if saved is None:
            del sys.modules["datasets"]
        else:
            sys.modules["datasets"] = saved
    with open(os.path.join(out_dir, "fmow_high_res",
                           "TEOChat-7B_prompt_strategy_interleave_chronological_prefix_True.json")) as f:
        outputs = json.load(f)
    same = [a["response"] == b["response"] for a, b in zip(outputs, outputs_b1)]
    first = next((i for i, eq in enumerate(same) if not eq), None)
    where = "" if first is None else (
        f"; example {first} first differs at character "
        f"{_first_difference(outputs[first]['response'], outputs_b1[first]['response'])}: "
        f"{outputs[first]['response'][:60]!r} against {outputs_b1[first]['response'][:60]!r}")
    log(f"[checkpoint] eval('fmow_high_res', batch_size=4) through a stand-in load_dataset "
        f"{calls}: {sec:.3f} s, {sec / len(outputs):.3f} s an example (batch 1: {sec_b1:.3f}); "
        f"answers equal to batch 1's on {sum(same)} of {len(same)}{where}; metrics {metrics}")
    check(calls == [(("jirvin16/TEOChatlas",), {"split": "eval_fMoW_High_Res", "cache_dir": None,
                                                "trust_remote_code": True})],
          f"the split's read {calls}")
    check(len(outputs) == len(dataset) and all(o["response"] for o in outputs),
          "batched eval outputs")
    check(all(counts[k] > 0 for k in ("K1", "K2", "K5")), f"batched eval launches {counts}")
    return {"s_per_example": sec / len(outputs), "s_per_example_b1": sec_b1,
            "answers_equal": sum(same), "launches": counts}


# preprocess_frames on the card against its CPU run (the same fp32 products,
# summed in another order: ~1e-6) and against the native ImageProcessor on
# the same uint8 frames. The native path is PIL's fixed-point bicubic (a
# narrower antialias filter when it upsamples) and rounds the resized frame to
# uint8 before normalizing: read on the CPU over uniform noise frames, the
# mean |difference| 0.004-0.006 and the largest 0.06 (downsampling) to 0.6
# (upsampling) of a normalized value of range ~4; 0 on a 224 x 224 frame,
# which neither resizes
PREPROCESS_CPU_TOL = 1e-4
PREPROCESS_NATIVE_MEAN_TOL = 1e-2


def _device_preprocess(processor):
    """`ops/preprocess.py::preprocess_frames` on the card at four frame
    shapes: against its CPU run and the native ImageProcessor, and ms a
    frame (the upload of the uint8 frames and the card's work, and the
    card's work alone) beside the native path's."""
    from teochat_torch.ops.preprocess import preprocess_frames

    rs = np.random.RandomState(SEED + 9)
    size = processor.size
    out = {}
    for h, w in ((512, 640), (100, 120), (224, 224), (300, 200)):
        n = 8
        frames = rs.randint(0, 256, (n, h, w, 3), dtype=np.uint8)
        host = torch.from_numpy(frames)
        on_card = host.cuda()
        got = preprocess_frames(on_card, size)
        sync()
        err_cpu = (got.cpu() - preprocess_frames(host, size)).abs().max().item()
        diff = (got.cpu() - torch.from_numpy(processor.preprocess(list(frames))["pixel_values"])).abs()
        upload_ms = statistics.median(
            wall(lambda: preprocess_frames(host.cuda(), size))[1] for _ in range(5)) * 1e3 / n
        card_ms = time_ms(lambda: preprocess_frames(on_card, size)) / n
        native_ms = statistics.median(
            wall(lambda: processor.preprocess(list(frames)), "cpu")[1] for _ in range(3)) * 1e3 / n
        log(f"[preprocess] {n} uint8 frames of {h} x {w} -> {tuple(got.shape[1:])}: against "
            f"the CPU run max |diff| {err_cpu:.3e} (tol {PREPROCESS_CPU_TOL}); against the native "
            f"ImageProcessor mean |diff| {diff.mean().item():.3e} (tol "
            f"{PREPROCESS_NATIVE_MEAN_TOL}), largest {diff.max().item():.3e}; ms a frame: "
            f"{upload_ms:.4f} with the upload, {card_ms:.4f} on the card alone, native "
            f"{native_ms:.4f} on the host")
        check(got.shape == (n, 3, size, size) and torch.isfinite(got).all().item(),
              "preprocess_frames output")
        check(err_cpu <= PREPROCESS_CPU_TOL, f"preprocess_frames: the card against the CPU {err_cpu}")
        check(diff.mean().item() <= PREPROCESS_NATIVE_MEAN_TOL,
              f"preprocess_frames against the native path {diff.mean().item()}")
        out[f"{h}x{w}"] = {"ms_per_frame_upload": upload_ms, "ms_per_frame_card": card_ms,
                           "ms_per_frame_native": native_ms, "max_err_cpu": err_cpu,
                           "mean_diff_native": diff.mean().item()}
    return out


SERVE_FRAME_SIZES = ((300, 400), (256, 320), (333, 250), (400, 300))


def _png_b64(rs, size):
    """A seeded uint8 frame of `size` (rows, columns) as a base64 PNG."""
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rs.randint(0, 256, (*size, 3), dtype=np.uint8)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _http(port, path, payload=None):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method="GET" if payload is None else "POST",
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def _stateless_prefill_logits(model, ids, frames):
    """The last-position prefill logits of a stateless TEOChat.generate of the
    same conversation: a 1-token generate on the eager loop samples its one
    token from them."""
    g1 = GenerationConfig(max_new_tokens=1, temperature=0.0, do_sample=False, stop_strings=())
    with decode_loop(False) as last:
        model.generate([ids], frames, g1)
    return last["logits"][0]


def phase_server(model, tokenizer, image_processor):
    """The port's chat server on the loaded int8 model: `ChatServer` on
    127.0.0.1, an ephemeral port, in the background; over HTTP session "a"
    takes three greedy turns of 32 tokens (two base64 PNG frames of
    non-square sizes with timestamps; text only; a frame whose timestamp
    sorts before the others, which changes the committed prefix from the
    first frame on), session "b" one turn between a's first and second;
    then a fourth turn of "a" with `"speculative_k": 4`; then /reset of "a"
    and /stats. Each turn's last-position prefill logits in the session
    against a stateless prefill of the same conversation (relative L2 <=
    LOGITS_REL_L2_BOUND) and its 32 tokens against a stateless generate's
    (the spec turn's: each token within SPEC_GAP_TOL of its position's
    largest logit in a teacher-forced prefill, and beside a stateless
    generate with speculative_k 4); K1 and K5 must launch on a first turn,
    K2m on a's later turns, K2 on every turn but the spec turn, whose
    verify iterations run K2m alone; /stats must count a's spec_steps and
    spec_accepted. Then, from fresh sessions, turn 2's time to first token
    beside a stateless re-prefill of the whole conversation and the
    session's decode ms/step. Returns K2m's launches over the five HTTP
    turns."""
    from teochat_torch.serve import session as session_mod
    from teochat_torch.serve.chat import Chat
    from teochat_torch.serve.server import ChatServer

    gen_mod.clear_decode_graphs()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    rs = np.random.RandomState(SEED + 2)
    turns = [  # (session, prompt, frames as (size, timestamp), speculative_k)
        ("a", "What changed between these images?",
         [(SERVE_FRAME_SIZES[0], "2019-05-01"), (SERVE_FRAME_SIZES[1], "2019-09-01")], 0),
        ("b", "Describe the land use in this image.", [(SERVE_FRAME_SIZES[3], "2020-01-01")], 0),
        ("a", "Where are the damaged buildings? Answer with bounding boxes.", [], 0),
        ("a", "And compared with this earlier image?", [(SERVE_FRAME_SIZES[2], "2018-12-01")],
         0),
        ("a", "Repeat the bounding boxes of the damaged buildings.", [], 4),
    ]
    seen, captures = [], [0]
    generate, prefill_full, prefill_suffix = (session_mod.ChatSession.generate,
                                              gen_mod.prefill_full, gen_mod.prefill_suffix)
    capture = gen_mod.DecodeGraph._warm_up_and_capture

    def recorded(self, input_ids, pixel_values, gen=None, rng=None):
        seen.append({"ids": list(input_ids), "gen": gen, "session": self,
                     "frames": None if pixel_values is None else np.array(pixel_values)})
        seen[-1]["out"] = generate(self, input_ids, pixel_values, gen, rng)
        return seen[-1]["out"]

    def prefill(fn, kind):
        def run(*args, **kwargs):
            logits, cache = fn(*args, **kwargs)
            seen[-1].update(logits=logits[0].clone(), prefill=kind)
            return logits, cache
        return run

    def counted_capture(self, *args):
        captures[0] += 1
        return capture(self, *args)

    session_mod.ChatSession.generate = recorded
    gen_mod.prefill_full = prefill(prefill_full, "full")
    gen_mod.prefill_suffix = prefill(prefill_suffix, "suffix")
    gen_mod.DecodeGraph._warm_up_and_capture = counted_capture
    server = ChatServer(Chat(model_bundle=(tokenizer, model, image_processor)),
                        host="127.0.0.1", port=0).start_background()
    port = server._httpd.server_address[1]
    k2m = http_captures = 0
    try:
        for i, (sid, prompt, frames, spec_k) in enumerate(turns):
            payload = {"prompt": prompt, "images": [_png_b64(rs, size) for size, _ in frames],
                       "timestamps": [ts for _, ts in frames], "temperature": 0.0,
                       "max_new_tokens": 32, "session_id": sid, "speculative_k": spec_k}
            for counter in INFERENCE_COUNTERS.values():
                counter.reset()
            before = captures[0]
            (code, answer), sec = wall(lambda: _http(port, "/generate", payload))
            counts = {name: c.count for name, c in INFERENCE_COUNTERS.items()}
            http_captures += captures[0] - before
            turn = seen[-1]
            check(code == 200 and isinstance(answer["response"], str),
                  f"turn {i}: HTTP {code} {answer}")
            stateless = _stateless_prefill_logits(model, turn["ids"], turn["frames"])
            got = turn["logits"]
            rel = ((got - stateless).norm() / stateless.norm()).item()
            with decode_loop(False), spec_loop(False):  # eager: no graph entry of its own
                want = model.generate([turn["ids"]], turn["frames"], turn["gen"])[0]
            agree = sum(a == b for a, b in zip(turn["out"], want))
            stats = dict(turn["session"].stats)
            if spec_k:
                gaps, _ = teacher_forced_gaps(model, turn["ids"], turn["frames"], turn["out"])
                log(f"[serve] turn {i} (speculative_k {spec_k}): each token's gap to its "
                    f"position's largest logit in a teacher-forced prefill: largest "
                    f"{max(gaps):.3e} rms (bound {SPEC_GAP_TOL}); the session's tokens first "
                    f"leave a stateless generate's (speculative_k {spec_k}) at "
                    f"{_first_difference(turn['out'], want)}")
                check(max(gaps) <= SPEC_GAP_TOL, f"turn {i}: a spec token {max(gaps)} rms "
                      f"below its position's largest logit")
                check(stats.get("spec_steps", 0) >= 1 and "spec_accepted" in stats,
                      f"turn {i}: the session counted no verify iteration {stats}")
            log(f"[serve] turn {i} session {sid!r} ({len(frames)} new frames): HTTP {code} in "
                f"{sec:.3f} s; prefill {turn['prefill']} of {len(turn['ids'])} tokens (session "
                f"{stats}); logits vs a stateless prefill: rel L2 {rel:.3e} (bound "
                f"{LOGITS_REL_L2_BOUND}), argmax {int(got.argmax())} vs {int(stateless.argmax())}; "
                f"{agree} of {len(want)} tokens agree with a stateless generate "
                f"({len(turn['out'])} from the session); launches {counts}; "
                f"answer={answer['response'][:80]!r}")
            check(rel <= LOGITS_REL_L2_BOUND, f"turn {i}: session logits rel L2 {rel}")
            if spec_k:  # the suffix prefill's K2m a layer, then the verify iterations'
                check(counts["K2"] == 0 and counts["K2m"] >= 2 * model.cfg.llm.num_layers,
                      f"turn {i}: no verify iteration ran {counts}")
            else:
                check(counts["K2"] > 0, f"turn {i}: no decode step ran {counts}")
            if turn["prefill"] == "full":
                check(i in (0, 1) and counts["K1"] > 0 and counts["K5"] > 0,
                      f"turn {i}: a first turn without K1 and K5 {counts}")
            else:
                check(i in (2, 3, 4) and counts["K2m"] > 0,
                      f"turn {i}: a later turn without K2m {counts}")
                check((counts["K5"] > 0) == (i == 3), f"turn {i}: frames encoded {counts}")
            k2m += counts["K2m"]
        caches = {sid: c._session.cache for sid, c in server._sessions.items()
                  if c._session.cache is not None}
        sizes = {sid: (c.k.numel() * c.k.element_size() * 2) / 2**30 for sid, c in caches.items()}
        live = len(gen_mod.decode_graphs())
        del caches
        log(f"[serve] session caches {', '.join(f'{k}: {v:.3f} GiB' for k, v in sizes.items())}; "
            f"{http_captures} decode graph captures over the five turns, {live} graphs live; "
            f"peak allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
            f"({held / 2**30:.3f} GiB held before the phase)")
        # a plain graph for a and b, a spec graph for a: each over its session's cache
        check(set(sizes) == {"a", "b"} and http_captures == 3 and live == 3,
              f"sessions {sorted(sizes)}, captures {http_captures}, graphs {live}")
        check(_http(port, "/reset", {"session_id": "a"}) == (200, {"status": "reset"}), "reset")
        code, stats = _http(port, "/stats")
        log(f"[serve] after /reset of 'a': {len(gen_mod.decode_graphs())} graphs live; "
            f"/stats {stats}")
        check(server._sessions["a"]._session.cache is None and
              len(gen_mod.decode_graphs()) == live - 2, "reset dropped a's cache and its graphs")
        a_stats = stats["sessions"]["a"]
        check(code == 200 and stats["sessions"]["b"]["turns"] == 1 and a_stats["turns"] == 4
              and a_stats["spec_steps"] >= 1 and a_stats["spec_accepted"] >= 0
              and "spec_steps" not in stats["sessions"]["b"], f"/stats {stats}")
    finally:
        server.shutdown()
        session_mod.ChatSession.generate = generate
        gen_mod.prefill_full, gen_mod.prefill_suffix = prefill_full, prefill_suffix
        gen_mod.DecodeGraph._warm_up_and_capture = capture
    check(not server._worker_thread.is_alive() and not server._serve_thread.is_alive(),
          "the server's threads stopped")

    # turn 2 from fresh sessions: TTFT (1 token) and the decode ms/step (32
    # tokens less 1) after the same turn 1, beside a stateless re-prefill
    first, second = seen[0], seen[2]
    g1 = dataclasses.replace(second["gen"], max_new_tokens=1)
    ttft, full, stateless, steps = [], [], [], 0
    for _ in range(3):
        for gen, times in ((g1, ttft), (second["gen"], full)):
            session = session_mod.ChatSession(model)
            session.generate(first["ids"], first["frames"], first["gen"])
            out, sec = wall(lambda: session.generate(second["ids"], second["frames"], gen))
            times.append(sec)
            steps = max(len(out) - 1, 1) if gen is not g1 else steps
            del session
        stateless.append(wall(lambda: model.generate([second["ids"]], second["frames"], g1))[1])
    t1, t32, ts = statistics.median(ttft), statistics.median(full), statistics.median(stateless)
    log(f"[serve] turn 2 ({len(second['ids'])} tokens, {len(second['ids']) - len(first['ids'])} "
        f"more than turn 1): time to first token through the session {t1 * 1e3:.2f} ms, a "
        f"stateless re-prefill of the whole conversation {ts * 1e3:.2f} ms (x{ts / t1:.2f}); "
        f"session decode {(t32 - t1) / steps * 1e3:.2f} ms/step over {steps} graphed steps "
        f"(medians of 3 fresh sessions; TTFT {min(ttft) * 1e3:.2f}-{max(ttft) * 1e3:.2f} ms)")
    gen_mod.clear_decode_graphs()
    return k2m


# ------------------------------------------------------------ the serving engine

ENGINE_PREFIX = [1] + list(range(300, 620))  # a 321-token text run two requests share


def _engine_prompts(tokenizer, image_processor, rs):
    """The engine phase's eight requests: (name, ids, frames, gen). Frames
    are seeded uint8 images through the loaded ImageProcessor."""
    def frames(n):
        return image_processor.preprocess(
            [rs.randint(0, 256, (*SERVE_FRAME_SIZES[i % 4], 3), dtype=np.uint8)
             for i in range(n)])["pixel_values"]

    def ids_of(text):
        return tokenizer_image_token(text, tokenizer, IMAGE_TOKEN_INDEX)

    def greedy(n, stops=()):
        return GenerationConfig(max_new_tokens=n, temperature=0.0, do_sample=False,
                                stop_strings=stops)

    video4 = " ".join(f"Image {i + 1}: <image>" for i in range(4))
    long_text = " ".join(f"w{1000 + i}" for i in range(160))  # ~1,200 fused tokens in all
    return [
        ("2-frame", ids_of(PROMPT_2.replace("<video>", "Image 1: <image> Image 2: <image>")),
         frames(2), greedy(32)),
        ("4-frame long", ids_of(PROMPT_4.replace("<video>", video4) + " " + long_text),
         frames(4), greedy(32)),
        ("text", ids_of("What is a satellite image? Describe the land use."), None, greedy(32)),
        ("one token", ids_of("Image 1 2 3 4"), None, greedy(1)),
        ("stop string", ids_of("Has any land been cleared for construction?"), None,
         None),  # its stop string comes from its own greedy answer
        ("sampled t 0.8", ids_of("Identify the damaged buildings."), None,
         GenerationConfig(max_new_tokens=32, temperature=0.8, do_sample=True, stop_strings=())),
        ("prefix miss", ENGINE_PREFIX + [700, 701, 702], None, greedy(32)),
        ("prefix hit", ENGINE_PREFIX + [710, 711, 712, 713], None, greedy(32)),
    ]


def _serve_named(engine, requests, adapters=None):
    """Start `engine` and send `requests` [(name, ids, frames, gen)] from
    threads at once (the prefix hit once the miss is answered, so that the
    pool holds its prefix), each with its adapter of `adapters` {name: id}
    (-1 where none); returns {name: (tokens, seconds)}."""
    results, done = {}, {name: threading.Event() for name, *_ in requests}
    adapters = adapters or {}

    def submit(name, ids, frames, gen):
        if name == "prefix hit":
            done["prefix miss"].wait()
        try:
            results[name] = wall(lambda: engine.submit(ids, frames, gen,
                                                       adapter=adapters.get(name, -1)))
        finally:
            done[name].set()

    engine.start()
    threads = [threading.Thread(target=submit, args=r) for r in requests]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def _engine_snapshot(engine):
    """The engine's device state and cache, and its generator's state."""
    st = engine._state
    names = ("last_tokens", "positions", "active", "temperature", "do_sample", "hist",
             "hist_len", "adapter", "tokens", "col", "spec_tokens", "spec_counts")
    return ({n: getattr(st, n).clone() for n in names if getattr(st, n) is not None},
            engine.cache.k.clone(),
            engine.cache.v.clone(), st.generator.get_state())


def _engine_restore(engine, snap):
    """Write a snapshot back in place (the graph reads these addresses)."""
    fields, k, v, gen_state = snap
    for n, t in fields.items():
        getattr(engine._state, n).copy_(t)
    engine.cache.k.copy_(k)
    engine.cache.v.copy_(v)
    engine._state.generator.set_state(gen_state)


def _admit_directly(engine, prompts):
    """Prefill `prompts` [(ids, gen)] into slots 0.. of an engine that is not
    started, through its own admission code, and read their first tokens."""
    for slot, (ids, gen) in enumerate(prompts):
        req = engine._make_request(ids, None, gen)
        engine._slots[slot] = req
        engine._prefill(req, slot)
    engine._resolve_pending_first()


def _engine_graph_check(model, tag):
    """The engine's decode graph against its eager step over one chunk from
    the same state (three rows prefilled, one left empty): the same tokens,
    cache and launch counts, twice (the first graphed chunk holds the
    warm-up step and the capture); then a host read planted in the step
    must fail the capture of a fresh engine."""
    from teochat_torch.serve.engine import BatchEngine

    g32 = GenerationConfig(max_new_tokens=64, temperature=0.0, do_sample=False, stop_strings=())
    prompts = [([1] + list(range(40 + 7 * r, 60 + 11 * r)), g32) for r in range(3)]
    engine = BatchEngine(model, max_slots=4, max_len=512, chunk=8)
    _admit_directly(engine, prompts)
    llm, kw = model.params["llm"], engine._step_kw()
    snap = _engine_snapshot(engine)
    runs = []
    for graph in (None, engine._decode_graph(), engine._decode_graph()):
        _engine_restore(engine, snap)
        toks, counts = counted(f"{tag} graph={graph is not None}", lambda: engine_mod._decode_chunk(
            llm, model.cfg.llm, engine._state, chunk=engine.chunk, graph=graph, **kw).clone())
        runs.append((toks, counts, engine.cache.k.clone(), engine.cache.v.clone()))
    (want, want_counts, wk, wv) = runs[0]
    for i, (toks, counts, k, v) in enumerate(runs[1:]):
        diff = max((k.float() - wk.float()).abs().max().item(),
                   (v.float() - wv.float()).abs().max().item())
        log(f"[{tag}] graphed chunk {i + 1} "
            f"({'warm-up, capture and 7 replays' if i == 0 else '8 replays'}) against the eager "
            f"chunk: tokens {'equal' if torch.equal(toks, want) else 'DIFFER'}, the cache's "
            f"largest difference {diff:.3e}, launches {counts} (eager {want_counts})")
        check(torch.equal(toks, want) and counts == want_counts,
              f"{tag}: the engine's graph against its eager step")
    check(want_counts["K2"] == model.cfg.llm.num_layers * engine.chunk,
          f"{tag}: K2 once a layer a step {want_counts}")
    graph = engine._graph
    log(f"[{tag}] the engine's graph: captured in {graph.capture_seconds:.3f} s, "
        f"{graph.replays} replays")
    engine.shutdown()
    check(engine._graph is None and graph.graph is None, f"{tag}: shutdown dropped the graph")

    sample = engine_mod._sample_rows

    def reads_back(logits, generator, temperature, do_sample):
        out = sample(logits, generator, temperature, do_sample)
        out.sum().item()
        return out

    engine = BatchEngine(model, max_slots=4, max_len=512, chunk=8)
    _admit_directly(engine, prompts[:1])
    engine_mod._sample_rows = reads_back
    try:
        engine._dispatch_chunk()
    except RuntimeError as err:
        raised = f"{type(err).__name__}: {str(err).splitlines()[0][:120]}"
    else:
        raised = None
    finally:
        engine_mod._sample_rows = sample
    log(f"[{tag}] a capture with a host read in the engine's step: {raised or 'did NOT raise'}")
    check(raised is not None and engine._graph.graph is None,
          f"{tag}: a failed capture did not raise, or left a graph")
    engine.shutdown()


SPEC_STATE = ("spec_tokens", "spec_counts", "hist", "hist_len", "positions", "active",
              "last_tokens")


def _spec_graph_check(model, tag):
    """The engine's speculative graph against its eager step over one chunk
    from the same state (three rows prefilled, one left empty): tokens,
    counts, hist, positions and launch counts bit-equal, twice; the cache
    compared outside the trash slot, which an inactive row writes k + 1
    times in one scatter (an order CUDA leaves open, and no query reads
    it). Then a host read planted in the step must fail the capture."""
    from teochat_torch.serve.engine import BatchEngine

    g64 = GenerationConfig(max_new_tokens=64, temperature=0.0, do_sample=False, stop_strings=())
    prompts = [([1] + list(range(40 + 7 * r, 60 + 11 * r)), g64) for r in range(3)]
    engine = BatchEngine(model, max_slots=4, max_len=512, chunk=8, speculative_k=4)
    _admit_directly(engine, prompts)
    llm, kw = model.params["llm"], engine._step_kw(spec=True)
    snap = _engine_snapshot(engine)
    runs = []
    for graph in (None, engine._decode_graph(spec=True), engine._decode_graph(spec=True)):
        _engine_restore(engine, snap)

        def chunk():
            engine_mod._decode_chunk_spec(llm, model.cfg.llm, engine._state, chunk=engine.chunk,
                                          graph=graph, **kw)
            return {n: getattr(engine._state, n).clone() for n in SPEC_STATE}

        fields, counts = counted(f"{tag} graph={graph is not None}", chunk)
        k, v = engine.cache.k.clone(), engine.cache.v.clone()
        k[:, :, -1], v[:, :, -1] = 0, 0
        runs.append((fields, counts, k, v))
    want, want_counts, wk, wv = runs[0]
    for i, (fields, counts, k, v) in enumerate(runs[1:]):
        same = [n for n in SPEC_STATE if torch.equal(fields[n], want[n])]
        cache_same = torch.equal(k, wk) and torch.equal(v, wv)
        log(f"[{tag}] graphed spec chunk {i + 1} "
            f"({'warm-up, capture and 7 replays' if i == 0 else '8 replays'}) against the eager "
            f"chunk: equal {same}; the cache outside the trash slot "
            f"{'equal' if cache_same else 'DIFFERS'}; launches {counts} (eager {want_counts})")
        check(len(same) == len(SPEC_STATE) and cache_same and counts == want_counts,
              f"{tag}: the speculative graph against its eager step")
    layers = model.cfg.llm.num_layers
    check(want_counts["K2m"] == layers * engine.chunk and want_counts["K2"] == 0,
          f"{tag}: K2m once a layer a verify iteration and K2 never {want_counts}")
    emitted = want["spec_counts"][:3]
    log(f"[{tag}] the chunk's tokens an iteration on rows 0-2 (random weights): "
        f"{emitted.tolist()}")
    graph = engine._spec_graph
    capture_s, replays = graph.capture_seconds, graph.replays
    log(f"[{tag}] the engine's speculative graph: captured in {capture_s:.3f} s, "
        f"{replays} replays")
    engine.shutdown()
    check(engine._spec_graph is None and graph.graph is None, f"{tag}: shutdown dropped the graph")

    emissions = engine_mod._spec_emissions

    def reads_back(*args):
        out = emissions(*args)
        out[1].sum().item()
        return out

    engine = BatchEngine(model, max_slots=4, max_len=512, chunk=8, speculative_k=4)
    _admit_directly(engine, prompts[:1])
    engine_mod._spec_emissions = reads_back
    try:
        engine._dispatch_chunk()
    except RuntimeError as err:
        raised = f"{type(err).__name__}: {str(err).splitlines()[0][:120]}"
    else:
        raised = None
    finally:
        engine_mod._spec_emissions = emissions
    log(f"[{tag}] a capture with a host read in the speculative step: "
        f"{raised or 'did NOT raise'}")
    check(raised is not None and engine._spec_graph.graph is None,
          f"{tag}: a failed capture did not raise, or left a graph")
    engine.shutdown()
    return {"capture_s": capture_s, "replays": replays}


def _chunk_ms(model, prompts, tag, reps=3):
    """ms a plain chunk and a speculative chunk of 8 steps (k = 4) over the
    same `prompts` [(ids, gen)] admitted into an engine of as many rows,
    each replayed from its graph (both graphs over one state), the median
    of `reps` after one that captures; with the spec chunks' launches and
    their tokens an iteration on the live rows."""
    from teochat_torch.serve.engine import BatchEngine

    engine = BatchEngine(model, max_slots=len(prompts), max_len=512, chunk=8, speculative_k=4)
    _admit_directly(engine, prompts)
    llm, cfg = model.params["llm"], model.cfg.llm
    plain, spec = engine._decode_graph(), engine._decode_graph(spec=True)

    def run_plain():
        engine_mod._decode_chunk(llm, cfg, engine._state, chunk=8, graph=plain,
                                 **engine._step_kw())

    def run_spec():
        engine_mod._decode_chunk_spec(llm, cfg, engine._state, chunk=8, graph=spec,
                                      **engine._step_kw(spec=True))

    out = {}
    for name, fn in (("spec", run_spec), ("plain", run_plain)):
        wall(fn)  # warm-up and capture
        (times, counts) = counted(f"{tag} {name} chunks", lambda: [wall(fn)[1]
                                                                   for _ in range(reps)])
        out[f"{name}_chunk_ms"] = statistics.median(times) * 1e3
        out[f"{name}_launches"] = counts
        if name == "spec":
            live = engine._state.spec_counts[engine._state.spec_counts > 0].float()
            out["spec_tokens_per_iteration"] = live.mean().item() if live.numel() else 0.0
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag}] {_timing.smi_line()}: {len(prompts)} rows, a chunk of 8 steps replayed: plain "
        f"{out['plain_chunk_ms']:.2f} ms ({out['plain_chunk_ms'] / 8:.2f} ms a step), "
        f"speculative k 4 {out['spec_chunk_ms']:.2f} ms ({out['spec_chunk_ms'] / 8:.2f} ms a "
        f"verify iteration of {len(prompts) * 5} rows), x{out['spec_chunk_ms'] / out['plain_chunk_ms']:.2f}; "
        f"the last spec chunk's tokens an iteration on live rows "
        f"{out['spec_tokens_per_iteration']:.2f}; captures {plain.capture_seconds:.3f} / "
        f"{spec.capture_seconds:.3f} s; peak allocated {out['peak_gib']:.3f} GiB")
    engine.shutdown()
    return out


def _chunked_against_monolithic(model, ids, frames, prefill_chunk):
    """The last-position logits of `ids` prefilled in pieces of
    `prefill_chunk` (K2m over the row, as the engine's pieces) against a
    stateless monolithic prefill (K1): relative L2."""
    cfg, llm = model.cfg, model.params["llm"]
    tpf = model.tokens_per_frame
    fused = len(ids) + sum(t == IMAGE_TOKEN_INDEX for t in ids) * (tpf - 1)
    n = -(-fused // prefill_chunk)
    plan = fusion_mod.build_fusion_plan([ids], tokens_per_frame=tpf, pad_to=n * prefill_chunk,
                                        max_length=2048)
    emb = teochat_mod.fuse_embeds(llm, plan, model.encode(frames))
    cache = llama_mod.init_cache(cfg.llm, 1, n * prefill_chunk + 1, dtype=torch.bfloat16,
                                 device="cuda")
    with torch.no_grad():
        for i in range(n - 1):
            engine_mod._prefill_chunk_write(llm, cache, cfg.llm,
                                            emb[:, i * prefill_chunk:(i + 1) * prefill_chunk],
                                            i * prefill_chunk, 0, -1)
        start = (n - 1) * prefill_chunk
        pos = torch.arange(start, start + prefill_chunk, dtype=torch.int32, device="cuda")[None]
        got = llama_mod.llama_forward(
            llm, cfg.llm, emb[:, start:], position_ids=pos, cache=cache, write_slots=pos,
            logits_mode="last", last_index=torch.tensor([fused - 1 - start], device="cuda"),
            prefill_start=start, attend_cache=True)[0, 0]
    want = _stateless_prefill_logits(model, ids, frames)
    return ((got - want).norm() / want.norm()).item(), n


def phase_engine(model, tokenizer, image_processor):
    """The continuous-batching engine (serve/engine.py) on the loaded int8
    model: (a) eight requests at once, (b) aggregate tok/s at 8 and 16
    streams beside one request at a time, (c) the prefix hit and miss TTFT,
    the chat server in engine mode over HTTP, and the engine's graph
    against its eager step. Returns the phase's entry of the JSON line."""
    from teochat_torch.serve import session as session_mod
    from teochat_torch.serve.chat import Chat
    from teochat_torch.serve.engine import BatchEngine
    from teochat_torch.serve.server import ChatServer

    gen_mod.clear_decode_graphs()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    rs = np.random.RandomState(SEED + 3)
    entry = {}

    # (a) eight requests at once: frames, text, one token, a stop string, a
    # sampled one, a long prompt prefilled in pieces, a prefix miss then a hit
    requests = _engine_prompts(tokenizer, image_processor, rs)
    refs = {}
    for name, ids, frames, gen in requests:
        if name == "stop string":  # stop at the text of its own third greedy token
            full = model.generate([ids], frames, GenerationConfig(
                max_new_tokens=32, temperature=0.0, do_sample=False, stop_strings=()))[0]
            stop = tokenizer.decode([full[2]])
            gen = GenerationConfig(max_new_tokens=32, temperature=0.0, do_sample=False,
                                   stop_strings=(stop,))
            requests[[r[0] for r in requests].index(name)] = (name, ids, frames, gen)
        if not gen.do_sample:
            refs[name] = model.generate([ids], frames, gen)[0]
    engine = BatchEngine(model, max_slots=8, max_len=2048, chunk=8, prefill_chunk=256,
                         prefix_cache_slots=2, prefix_min_tokens=256)
    fused = {name: engine._fused_len(ids) for name, ids, _, _ in requests}
    (results, wall_s), counts = counted("engine (a)",
                                        lambda: wall(lambda: _serve_named(engine, requests)))
    capture_s, replays = engine._graph.capture_seconds, engine._graph.replays
    engine.shutdown()
    cache_gib = engine.cache.k.numel() * engine.cache.k.element_size() * 2 / 2**30
    stats = dict(engine.stats)
    check(set(results) == set(fused), f"engine (a): answered {sorted(results)}")
    for name, ids, frames, gen in requests:
        out, sec = results[name]
        line = (f"[engine a] {name}: {fused[name]} fused tokens, {len(out)} tokens in "
                f"{sec:.3f} s")
        if gen.do_sample:
            check(1 <= len(out) <= 32 and all(0 <= t < model.cfg.llm.vocab_size for t in out),
                  f"engine (a) {name}: {out}")
            log(line + " (sampled: ids in range)")
            continue
        gaps, _ = teacher_forced_gaps(model, ids, frames, out)
        first = _first_difference(out, refs[name])
        log(line + f"; against TEOChat.generate: first difference at {first}; largest gap to "
            f"its position's largest logit {max(gaps):.3e} rms (bound {SPEC_GAP_TOL})")
        check(max(gaps) <= SPEC_GAP_TOL, f"engine (a) {name}: a token {max(gaps)} rms below "
              f"its position's largest logit")
        if name == "one token":
            check(len(out) == 1, f"engine (a): max_new_tokens 1 gave {out}")
        if name == "stop string":  # it fires where the engine's tokens reach it
            stop = gen.stop_strings[0]
            fired = stop in tokenizer.decode(out)
            log(f"[engine a] the stop string {stop!r} {'fired' if fired else 'did NOT fire'} "
                f"after {len(out)} tokens")
            check(fired or out[:3] != refs[name][:3], f"engine (a): {stop!r} did not fire")
            check(not fired or stop not in tokenizer.decode(out[:-1]),
                  f"engine (a): tokens after the stop string {stop!r}")
    long_ids, long_frames = requests[1][1], requests[1][2]
    rel, pieces = _chunked_against_monolithic(model, long_ids, long_frames, 256)
    log(f"[engine a] the long request in {pieces} pieces of 256: its last logits against a "
        f"monolithic prefill, rel L2 {rel:.3e} (bound {LOGITS_REL_L2_BOUND})")
    check(rel <= LOGITS_REL_L2_BOUND, f"engine (a): pieces against monolithic {rel}")
    check(stats["prefix_hits"] >= 1, f"engine (a): no prefix hit {stats}")
    check(all(counts[k] > 0 for k in ("K1", "K2", "K2m", "K5")), f"engine (a) launches {counts}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[engine a] 8 requests in {wall_s:.3f} s; stats {stats}; the longest wait of a running "
        f"stream between two chunks {stats['max_chunk_gap_s'] * 1e3:.2f} ms (a chunk of 8 steps "
        f"with admissions and pieces between); decode graph captured in "
        f"{capture_s:.3f} s, {replays} replays; cache "
        f"{cache_gib:.3f} GiB (8 + 2 rows of 2,048 slots); peak allocated {peak:.3f} GiB "
        f"({held / 2**30:.3f} GiB held before); launches {counts}")
    entry["a"] = {"wall_s": wall_s, "launches": counts, "prefix_hits": stats["prefix_hits"],
                  "max_chunk_gap_s": stats["max_chunk_gap_s"],
                  "capture_s": capture_s, "cache_gib": cache_gib, "peak_gib": peak}
    del engine
    gc.collect()

    # the graph against the eager step, and a planted host read
    _engine_graph_check(model, "engine graph")

    # (b) aggregate tok/s at 8 and 16 text streams of 64 new tokens
    g64 = GenerationConfig(max_new_tokens=64, temperature=0.0, do_sample=False, stop_strings=())
    prompts = [[1] + list(range(10 + i, 130 + i)) for i in range(8)]
    engine = BatchEngine(model, max_slots=16, max_len=512, chunk=16).start()
    try:
        engine.submit(prompts[0], None, g64)  # the capture

        def serve(batch):
            threads = [threading.Thread(target=engine.submit, args=(p, None, g64))
                       for p in batch]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

        t8 = wall(lambda: serve(prompts))[1]
        t16 = wall(lambda: serve(prompts * 2))[1]
    finally:
        engine.shutdown()
    del engine
    one_by_one = wall(lambda: [model.generate([p], None, g64) for p in prompts[:4]])[1]
    smi = _timing.smi_line()
    log(f"[engine b] {smi}: 8 streams of 121 + 64 tokens {t8:.3f} s, {8 * 64 / t8:.2f} tok/s; "
        f"16 streams (the 8 prompts twice) {t16:.3f} s, {16 * 64 / t16:.2f} tok/s; 4 of the "
        f"requests one at a time through TEOChat.generate {one_by_one:.3f} s, "
        f"{4 * 64 / one_by_one:.2f} tok/s")
    entry["b"] = {"tok_s_8": 8 * 64 / t8, "tok_s_16": 16 * 64 / t16,
                  "tok_s_one_at_a_time": 4 * 64 / one_by_one, "smi": smi}

    # (c) the prefix hit and miss TTFT at a 512-token prefix (bench ttft_prefix)
    miss, hit, _ = bench_main._ttft_prefix_at(bench_main.Settings(), model, 512, 1024, pool=4)
    log(f"[engine c] a 1-token request with a 512-token text prefix: miss {miss * 1e3:.2f} ms, "
        f"hit {hit * 1e3:.2f} ms (x{miss / hit:.2f}; medians of 3)")
    entry["c"] = {"ttft_miss_s": miss, "ttft_hit_s": hit}

    # the chat server in engine mode: four concurrent requests, one streamed;
    # a session turn sent while the engine captures its graph
    engine = BatchEngine(model, max_slots=4, max_len=1024, chunk=8).start()
    server = ChatServer(Chat(model_bundle=(tokenizer, model, image_processor)),
                        host="127.0.0.1", port=0, engine=engine).start_background()
    port = server._httpd.server_address[1]
    capture, prefill_full = gen_mod.DecodeGraph._warm_up_and_capture, gen_mod.prefill_full
    turn = {"prompt": "Describe the land use in this image.",
            "images": [_png_b64(rs, SERVE_FRAME_SIZES[3])], "timestamps": ["2020-01-01"],
            "temperature": 0.0, "max_new_tokens": 16, "session_id": "s"}
    session_seen, turn_thread = {}, []

    def capture_with_a_turn(self, *args):
        if self is engine._graph and not turn_thread:  # the engine's first capture
            turn_thread.append(threading.Thread(target=lambda: session_seen.update(
                answer=_http(port, "/generate", turn))))
            turn_thread[0].start()
            time.sleep(1.0)  # the turn reaches the worker, which waits for the device lock
            session_seen["during_capture"] = "ids" not in session_seen
        return capture(self, *args)

    def recorded_prefill(*args, **kwargs):
        logits, cache = prefill_full(*args, **kwargs)
        session_seen["logits"] = logits[0].clone()
        return logits, cache

    generate = session_mod.ChatSession.generate

    def recorded_generate(self, input_ids, pixel_values, gen=None, rng=None):
        session_seen.update(ids=list(input_ids), frames=np.array(pixel_values))
        return generate(self, input_ids, pixel_values, gen, rng)

    gen_mod.DecodeGraph._warm_up_and_capture = capture_with_a_turn
    gen_mod.prefill_full = recorded_prefill
    session_mod.ChatSession.generate = recorded_generate
    payloads = [{"prompt": f"What changed in scene {i}?", "images": [], "temperature": 0.0,
                 "max_new_tokens": 16} for i in range(4)]
    http = {}
    try:
        def post(i):
            if i == 3:  # streamed by server-sent events
                import urllib.request

                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/generate", method="POST",
                    data=json.dumps({**payloads[i], "stream": True}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=300) as r:
                    http[i] = [line.decode().strip() for line in r]
            else:
                http[i] = _http(port, "/generate", payloads[i])

        def post_all():
            threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

        (_, sec), counts = counted("engine http", lambda: wall(post_all))
        if turn_thread:
            turn_thread[0].join(300)
        events = [line[len("data: "):] for line in http[3] if line.startswith("data: ")]
        streamed = [t for e in events[:-1] for t in json.loads(e)["token_ids"]]
        blocking = engine.submit(*server._engine_request(payloads[3]))
        code, stats = _http(port, "/stats")
    finally:
        gen_mod.DecodeGraph._warm_up_and_capture = capture
        gen_mod.prefill_full = prefill_full
        session_mod.ChatSession.generate = generate
        server.shutdown()
        engine.shutdown()
    check(all(http[i][0] == 200 for i in range(3)) and events[-1] == "[DONE]",
          f"engine http: {http}")
    log(f"[engine http] 4 concurrent requests in {sec:.3f} s (one by SSE, {len(events) - 1} "
        f"events); the streamed token_ids {'equal' if streamed == blocking else 'DIFFER from'} "
        f"a blocking request's ({len(streamed)} tokens); launches {counts}; /stats {stats}")
    check(streamed == blocking and streamed, "engine http: the SSE tokens against a blocking "
          "request's")
    check(code == 200 and stats["mode"] == "continuous_batching" and stats["requests"] >= 5,
          f"engine http: /stats {stats}")
    code, answer = session_seen.get("answer", (None, None))
    stateless = _stateless_prefill_logits(model, session_seen["ids"], session_seen["frames"])
    rel = ((session_seen["logits"] - stateless).norm() / stateless.norm()).item()
    log(f"[engine http] a session turn sent during the engine's first capture "
        f"({'sent then' if session_seen.get('during_capture') else 'NOT sent then'}): HTTP "
        f"{code}, its prefill logits against a stateless prefill rel L2 {rel:.3e} (bound "
        f"{LOGITS_REL_L2_BOUND}); answer={(answer or {}).get('response', '')[:60]!r}")
    check(session_seen.get("during_capture") is True and code == 200
          and rel <= LOGITS_REL_L2_BOUND,
          "engine http: the session turn sent during the capture")
    gen_mod.clear_decode_graphs()

    entry["d"] = _engine_spec_requests(model, tokenizer, requests, results)
    entry["d"]["graph"] = _spec_graph_check(model, "engine spec graph")
    entry["d"]["chunks"] = _chunk_ms(model, [([1] + list(range(10 + i, 130 + i)), g64)
                                             for i in range(8)], "engine spec chunk int8")
    entry["f"] = _engine_adaptive_cell(model)
    gen_mod.clear_decode_graphs()
    entry["fp8"] = _engine_fp8(model, requests, results)
    gen_mod.clear_decode_graphs()
    return entry


def _engine_fp8(model, requests, plain_results):
    """(g) the eight requests of (a) through `BatchEngine(kv_dtype=
    "float8_e4m3fn")`, plain (chunked prefill, a prefix hit) and with
    speculative_k 4: each greedy token within SPEC_GAP_TOL of its
    teacher-forced maximum over e4m3 (teacher_forced_gaps_e4m3, the prompt
    prefilled as the engine prefilled it: in pieces over the cache past
    prefill_chunk, a prefix hit's suffix over the pooled prefix), its gap on
    the bf16 path and where it first leaves (a)'s printed; the e4m3 forms
    of K2 (plain steps) and K2m (pieces, the hit, verify blocks) launch and
    the bf16 ones never; the cache's GiB; then 8 text streams of 121 + 64
    tokens through an e4m3 and a bf16 engine (max_slots 16, max_len 512,
    chunk 16), one round each, aggregate tok/s."""
    from teochat_torch.serve.engine import BatchEngine

    out, k2m = {}, 0
    for name, kw in (("plain", dict(prefill_chunk=256, prefix_min_tokens=256)),
                     ("speculative", dict(speculative_k=4, adaptive_spec=False))):
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        engine = BatchEngine(model, max_slots=8, max_len=2048, chunk=8, prefix_cache_slots=2,
                             kv_dtype="float8_e4m3fn", **kw)
        check(engine.cache.k.dtype == E4M3, "engine fp8: the pool is not e4m3")
        (results, wall_s), counts = counted(f"engine fp8 {name}",
                                            lambda: wall(lambda: _serve_named(engine, requests)))
        engine.shutdown()
        stats = dict(engine.stats)
        cache_gib = 2 * engine.cache.k.numel() * engine.cache.k.element_size() / 2**30
        check(set(results) == {r[0] for r in requests}, f"engine fp8 {name}: {sorted(results)}")
        worst, tokens = 0.0, 0
        check(stats["prefix_hits"] == 1, f"engine fp8 {name}: one prefix hit, {stats}")
        for rname, ids, frames, gen in requests:
            toks, _ = results[rname]
            tokens += len(toks)
            if gen.do_sample:
                check(1 <= len(toks) <= 32
                      and all(0 <= t < model.cfg.llm.vocab_size for t in toks),
                      f"engine fp8 {name} {rname}: {toks}")
                continue
            if name == "plain" and engine._fused_len(ids) > engine.prefill_chunk:
                cached_from = 0  # in pieces, or a hit on a prefix that was
            elif rname == "prefix hit":
                cached_from = stats["prefix_tokens_saved"]
            else:
                cached_from = None
            gaps = teacher_forced_gaps_e4m3(model, ids, frames, toks, cached_from)
            gaps_bf16, _ = teacher_forced_gaps(model, ids, frames, toks)
            worst = max(worst, max(gaps))
            log(f"[engine fp8 {name}] {rname}: {len(toks)} tokens; first difference from the "
                f"bf16 engine (a) at {_first_difference(toks, plain_results[rname][0])}; largest "
                f"gap to its teacher-forced maximum over e4m3 {max(gaps):.3e} rms (bound "
                f"{SPEC_GAP_TOL}; the prompt over the cache from slot {cached_from}), over the "
                f"bf16 path {max(gaps_bf16):.3e} rms")
        check(worst <= SPEC_GAP_TOL, f"engine fp8 {name}: a token {worst} rms below its maximum")
        check(counts["K2"] == 0 and counts["K2m"] == 0 and counts["K2m e4m3"] > 0
              and (counts["K2 e4m3"] > 0) == (name == "plain"),
              f"engine fp8 {name}: launches {counts}, stats {stats}")
        k2m += counts["K2m e4m3"]
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[engine fp8 {name}] 8 requests in {wall_s:.3f} s ({tokens / wall_s:.2f} tok/s; the "
            f"bf16 engine (a) above); stats {stats}; cache {cache_gib:.3f} GiB (8 + 2 rows of "
            f"2,048 slots, e4m3); peak allocated {peak:.3f} GiB; launches {counts}")
        out[name] = {"wall_s": wall_s, "launches": counts, "largest_gap": worst,
                     "cache_gib": cache_gib, "peak_gib": peak}
        del engine
    g64 = GenerationConfig(max_new_tokens=64, temperature=0.0, do_sample=False, stop_strings=())
    prompts = [[1] + list(range(10 + i, 130 + i)) for i in range(8)]
    rates = {}
    for kv in ("float8_e4m3fn", "bfloat16"):
        engine = BatchEngine(model, max_slots=16, max_len=512, chunk=16, kv_dtype=kv).start()
        try:
            times, _ = _engine_streams(engine, prompts, g64, 1)
        finally:
            engine.shutdown()
        rates[kv] = [8 * 64 / t for t in times]
        del engine
    log(f"[engine fp8] {_timing.smi_line()}: 8 streams of 121 + 64 tokens, tok/s e4m3 "
        f"{', '.join(f'{r:.2f}' for r in rates['float8_e4m3fn'])} against bf16 "
        f"{', '.join(f'{r:.2f}' for r in rates['bfloat16'])}")
    out["tok_s_8"] = rates
    out["k2m_e4m3_launches"] = k2m
    return out


def _engine_spec_requests(model, tokenizer, requests, plain_results):
    """(d) the eight requests of (a) through the engine in speculative mode
    (k 4, not adaptive, a prefix pool of 2, no chunked prefill): each
    greedy token within SPEC_GAP_TOL of its teacher-forced maximum and where
    it first leaves the plain engine's; no K2 launch (every chunk is
    speculative), and K2m once a layer a verify iteration and a prefix hit."""
    from teochat_torch.serve.engine import BatchEngine

    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    engine = BatchEngine(model, max_slots=8, max_len=2048, chunk=8, speculative_k=4,
                         adaptive_spec=False, prefix_cache_slots=2)
    (results, wall_s), counts = counted("engine (d)",
                                        lambda: wall(lambda: _serve_named(engine, requests)))
    graph = engine._spec_graph
    capture_s, replays = graph.capture_seconds, graph.replays
    engine.shutdown()
    stats = dict(engine.stats)
    check(set(results) == {r[0] for r in requests}, f"engine (d): answered {sorted(results)}")
    worst = 0.0
    for name, ids, frames, gen in requests:
        out, sec = results[name]
        line = f"[engine d] {name}: {len(out)} tokens in {sec:.3f} s"
        if gen.do_sample:
            check(1 <= len(out) <= 32 and all(0 <= t < model.cfg.llm.vocab_size for t in out),
                  f"engine (d) {name}: {out}")
            log(line + " (sampled: ids in range)")
            continue
        gaps, _ = teacher_forced_gaps(model, ids, frames, out)
        worst = max(worst, max(gaps))
        log(line + f"; against the plain engine (a): first difference at "
            f"{_first_difference(out, plain_results[name][0])}; largest gap to its position's "
            f"largest logit {max(gaps):.3e} rms (bound {SPEC_GAP_TOL})")
        check(max(gaps) <= SPEC_GAP_TOL, f"engine (d) {name}: a token {max(gaps)} rms below "
              f"its position's largest logit")
        if name == "one token":
            check(len(out) == 1, f"engine (d): max_new_tokens 1 gave {out}")
        if name == "stop string":
            stop = gen.stop_strings[0]
            check(stop not in tokenizer.decode(out[:-1]),
                  f"engine (d): tokens after the stop string {stop!r}")
    iterations = stats["chunks"] * engine.chunk
    layers = model.cfg.llm.num_layers
    want_k2m = layers * (iterations + stats["prefix_hits"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    rate = stats["spec_tokens"] / max(stats["spec_iterations"], 1)
    log(f"[engine d] 8 requests in {wall_s:.3f} s; stats {stats}; {rate:.3f} tokens a row's "
        f"verify iteration; {stats['chunks']} speculative chunks of 8 iterations: K2m "
        f"{counts['K2m']} launches (layers x (iterations + prefix hits) = {want_k2m}), K2 "
        f"{counts['K2']}; speculative graph captured in {capture_s:.3f} s, {replays} replays; "
        f"peak allocated {peak:.3f} GiB ({held / 2**30:.3f} GiB held before)")
    check(counts["K2"] == 0 and counts["K2m"] == want_k2m and stats["prefix_hits"] >= 1,
          f"engine (d) launches {counts}, stats {stats}")
    check(all(counts[k] > 0 for k in ("K1", "K5")), f"engine (d) launches {counts}")
    return {"wall_s": wall_s, "launches": counts, "tokens_per_iteration": rate,
            "largest_gap": worst, "capture_s": capture_s, "peak_gib": peak}


def _engine_streams(engine, prompts, gen, runs):
    """Seconds of each of `runs` rounds of `prompts` sent at once, after one
    request that captures; and the tokens of the last round."""
    engine.submit(prompts[0], None, gen)
    out = [None] * len(prompts)

    def round_():
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(
            i, engine.submit(prompts[i], None, gen))) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    return [wall(round_)[1] for _ in range(runs)], out


def _engine_adaptive_cell(model):
    """(f) 8 text streams of 121 + 64 tokens on random weights (prompt
    lookup accepts next to nothing): the adaptive speculative engine (k 4,
    a re-probe every 4 plain chunks), four rounds (~5 chunks of 16 a round:
    drafting turns off after its first chunks at random weights, and the
    ~20 chunks that follow cross the probe's countdown several times),
    against the plain engine, two rounds; its mode switches and the probes
    it fired, at least one of each."""
    from teochat_torch.serve.engine import BatchEngine

    g64 = GenerationConfig(max_new_tokens=64, temperature=0.0, do_sample=False, stop_strings=())
    prompts = [[1] + list(range(10 + i, 130 + i)) for i in range(8)]
    out = {}
    for name, kw, runs in (("plain", {}, 2),
                           ("adaptive", dict(speculative_k=4, adaptive_spec=True,
                                             spec_probe_every=4), 4)):
        engine = BatchEngine(model, max_slots=8, max_len=512, chunk=16, **kw).start()
        try:
            times, _ = _engine_streams(engine, prompts, g64, runs=runs)
        finally:
            engine.shutdown()
        out[name] = {"tok_s": [8 * 64 / t for t in times], "stats": dict(engine.stats)}
    a = out["adaptive"]["stats"]
    log(f"[engine f] {_timing.smi_line()}: 8 streams of 121 + 64 tokens: plain (2 rounds) "
        f"{', '.join(f'{x:.2f}' for x in out['plain']['tok_s'])} tok/s; adaptive k 4 (4 rounds) "
        f"{', '.join(f'{x:.2f}' for x in out['adaptive']['tok_s'])} tok/s; the adaptive engine "
        f"switched {a.get('spec_mode_switches', 0)} times and fired {a.get('spec_probes', 0)} "
        f"probes over {a['chunks']} chunks ({a.get('spec_tokens', 0)} tokens in "
        f"{a.get('spec_iterations', 0)} row iterations of speculative chunks)")
    check(a.get("spec_mode_switches", 0) >= 1, f"engine (f): drafting never switched off {a}")
    check(a.get("spec_probes", 0) >= 1, f"engine (f): no re-probe fired {a}")
    return out


def _echo_weights(model):
    """Make `model` the echo model, in place: every layer's out and down
    projections zero (their int8 bytes: a zero scale would come from a zero
    amax), the lm_head the embedding shifted by one token and quantized as
    the lm_head is. The greedy successor of token t is then t + 1."""
    llm = model.params["llm"]
    llm["layers"]["attn"]["out"]["kernel"].zero_()
    llm["layers"]["mlp"]["down"]["kernel"].zero_()
    shifted = torch.roll(llm["embed_tokens"]["embedding"].float(), 1, dims=0).t().contiguous()
    q = quant_mod.quantize_kernel(shifted)
    for name in ("kernel", "scale"):
        llm["lm_head"][name].copy_(q[name])


def phase_engine_echo(model):
    """(e) the echo model at full width and depth (the loaded int8 model's
    leaves, changed in place after every other use): 8 streams, each a run
    of 80 successive ids then its first three again, 64 new tokens through
    the speculative engine (k 4, not adaptive) and the plain one: every
    draft the run holds is accepted. Tokens an iteration, aggregate tok/s
    both ways, ms a chunk both ways, and one request through
    TEOChat.generate, whose tokens the engines' must equal."""
    from teochat_torch.serve.engine import BatchEngine

    gen_mod.clear_decode_graphs()
    _echo_weights(model)
    g64 = GenerationConfig(max_new_tokens=64, temperature=0.0, do_sample=False, stop_strings=())
    starts = [1000 + 1000 * i for i in range(8)]
    prompts = [[1] + list(range(a, a + 80)) + [a, a + 1, a + 2] for a in starts]
    want = [list(range(a + 3, a + 67)) for a in starts]
    out = {}
    for name, kw in (("plain", {}), ("spec", dict(speculative_k=4, adaptive_spec=False))):
        engine = BatchEngine(model, max_slots=8, max_len=512, chunk=8, **kw).start()
        try:
            (times, tokens), counts = counted(f"engine echo {name}", lambda: _engine_streams(
                engine, prompts, g64, runs=2))
        finally:
            engine.shutdown()
        st = engine.stats
        out[name] = {"tok_s": [8 * 64 / t for t in times], "launches": counts,
                     "tokens_per_iteration": st.get("spec_tokens", 0) / max(
                         st.get("spec_iterations", 0), 1)}
        check(tokens == want, f"engine echo {name}: {[t[:8] for t in tokens]}")
    generated = model.generate([prompts[0]], None, g64)[0]
    # a run of 260 ids: enough for the 4 timed speculative chunks' drafts
    chunks = _chunk_ms(model, [([1] + list(range(a, a + 260)) + [a, a + 1, a + 2], g64)
                               for a in starts], "engine echo chunk")
    rate = out["spec"]["tokens_per_iteration"]
    log(f"[engine e] {_timing.smi_line()}: the echo model, 8 streams of 84 + 64 tokens, two "
        f"rounds: speculative {', '.join(f'{x:.2f}' for x in out['spec']['tok_s'])} tok/s at "
        f"{rate:.3f} tokens a row's verify iteration; plain "
        f"{', '.join(f'{x:.2f}' for x in out['plain']['tok_s'])} tok/s; TEOChat.generate's "
        f"tokens {'equal' if generated == want[0] else 'DIFFER from'} the engines'")
    check(rate > 1.0 and generated == want[0], f"engine echo: rate {rate}, generate {generated[:8]}")
    out["chunks"] = chunks
    gen_mod.clear_decode_graphs()
    return out


def phase_engine_int4(model):
    """One 4-stream engine run on the int4 model (K3b and K3c must launch),
    then a plain and a speculative chunk over 8 rows (`_chunk_ms`): the
    verify blocks' 40 rows must take K3's M > 8 kernel. Returns the chunk
    times."""
    from teochat_torch.serve.engine import BatchEngine

    gen = GenerationConfig(max_new_tokens=16, temperature=0.0, do_sample=False, stop_strings=())
    prompts = [[1] + list(range(20 + 3 * i, 60 + 5 * i)) for i in range(4)]
    engine = BatchEngine(model, max_slots=4, max_len=256, chunk=8).start()

    def serve():
        out = [None] * 4
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(
            i, engine.submit(prompts[i], None, gen))) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return out

    try:
        (out, sec), counts = counted("engine int4", lambda: wall(serve))
    finally:
        engine.shutdown()
    log(f"[engine int4] 4 streams of 16 tokens in {sec:.3f} s, {[len(o) for o in out]} tokens; "
        f"stats {engine.stats}")
    check(all(o and len(o) <= 16 for o in out), f"engine int4: {out}")
    check(counts["K3b"] > 0 and counts["K3c"] > 0 and counts["K3c M<=8"] > 0,
          f"engine int4 launches {counts}")
    # a speculative chunk at 8 rows: verify blocks of 8 x 5 = 40 rows take K3's M > 8 kernel
    g64 = GenerationConfig(max_new_tokens=64, temperature=0.0, do_sample=False, stop_strings=())
    chunks = _chunk_ms(model, [([1] + list(range(10 + i, 130 + i)), g64) for i in range(8)],
                       "engine int4 spec chunk")
    spec = chunks["spec_launches"]
    check(spec["K3c"] - spec["K3c M<=8"] > 0 and spec["K2"] == 0 and spec["K2m"] > 0,
          f"engine int4: a speculative chunk's launches {spec}")
    return chunks


# ------------------------------------------------------------- multi-LoRA

LORA_RANK, LORA_ALPHA = 128, 256.0  # the published recipe's r and alpha
LORA_STD = 0.015  # A and B: a delta of ~1/4 of the base's N(0, 0.02) weights


def write_peft_dir(path, cfg, gen):
    """A peft adapter dir at the model's full width: adapter_model.safetensors
    (fp16 A [r, in] and B [out, r] on all seven projections of every layer,
    both drawn on the card from `gen`, B nonzero) and adapter_config.json
    (r 128, lora_alpha 256). Returns its bytes."""
    from safetensors.torch import save_file

    llm = cfg.llm
    d, inter, kv = llm.hidden_size, llm.intermediate_size, llm.num_kv_heads * llm.head_dim
    widths = {"self_attn.q_proj": (d, d), "self_attn.k_proj": (d, kv),
              "self_attn.v_proj": (d, kv), "self_attn.o_proj": (d, d),
              "mlp.gate_proj": (d, inter), "mlp.up_proj": (d, inter), "mlp.down_proj": (inter, d)}

    def normal(*shape):
        return (torch.randn(shape, generator=gen, device="cuda") * LORA_STD).to(torch.float16).cpu()

    sd = {}
    for layer in range(llm.num_layers):
        for mod, (fan_in, fan_out) in widths.items():
            pre = f"base_model.model.model.layers.{layer}.{mod}"
            sd[f"{pre}.lora_A.weight"] = normal(LORA_RANK, fan_in)
            sd[f"{pre}.lora_B.weight"] = normal(fan_out, LORA_RANK)
    os.makedirs(path, exist_ok=True)
    save_file(sd, os.path.join(path, "adapter_model.safetensors"))
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": LORA_RANK, "lora_alpha": LORA_ALPHA, "peft_type": "LORA",
                   "target_modules": ["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                                      "up_proj", "down_proj"]}, f)
    return os.path.getsize(os.path.join(path, "adapter_model.safetensors"))


def _lora_bytes(llm) -> int:
    return sum(t.numel() * t.element_size() for path, t in tree_leaves_with_path(llm)
               if path.split("/")[-1].startswith("lora_"))


def _single_adapter_model(model, path):
    """The model with one adapter dir attached over its backbone (no stack)."""
    from safetensors.torch import load_file

    from teochat_torch.checkpoint.convert_hf import attach_lora_to_llama

    llm = attach_lora_to_llama(model.params["llm"], load_file(
        os.path.join(path, "adapter_model.safetensors")), model.cfg.llm, rank=LORA_RANK,
        alpha=LORA_ALPHA)
    return teochat_mod.TEOChat(model.cfg, {**model.params, "llm": llm},
                               tokenizer=model.tokenizer)


def _last_prefill_logits(model, ids, frames, adapters=None):
    """The last-position logits of one prefill of `ids`, as generate's (K1),
    routed by `adapters` over a multi-LoRA model."""
    from teochat_torch.train.lora import adapter_route, num_stacked_adapters

    cfg, tpf = model.cfg, model.tokens_per_frame
    fused = len(ids) + sum(t == IMAGE_TOKEN_INDEX for t in ids) * (tpf - 1)
    pad_to = teochat_mod.round_to_bucket(fused, teochat_mod.SEQ_BUCKETS)
    plan = fusion_mod.build_fusion_plan([ids], tokens_per_frame=tpf, pad_to=pad_to,
                                        max_length=cfg.tokenizer_model_max_length)
    embeds = teochat_mod.multimodal_embeds(model.params, cfg, plan, model.encode(frames))
    route = None if adapters is None else adapter_route(
        torch.tensor(adapters, device="cuda"), num_stacked_adapters(model.params["llm"]))
    cache = llama_mod.init_cache(cfg.llm, 1, pad_to + 1, device="cuda")
    logits, _ = gen_mod.prefill_full(
        model.params["llm"], cfg.llm, cache, embeds,
        torch.as_tensor(plan.seq_lens, device="cuda"),
        torch.as_tensor(plan.attention_mask, device="cuda"),
        torch.as_tensor(plan.position_ids, device="cuda"), adapter_route=route)
    return logits


def _decode_step_ms(model, ids, b, adapters=None, reps=2):
    """ms a graphed decode step at batch `b` (the text prompt `ids` in every
    row): (a 33-token generate - a 1-token one) / 32, medians of `reps`
    after a run that captures."""
    g1 = GenerationConfig(max_new_tokens=1, temperature=0.0, do_sample=False, stop_strings=())
    g33 = GenerationConfig(max_new_tokens=33, temperature=0.0, do_sample=False, stop_strings=())
    rows, route = [ids] * b, None if adapters is None else (adapters * b)[:b]
    model.generate(rows, None, g33, adapters=route)
    firsts = [wall(lambda: model.generate(rows, None, g1, adapters=route))[1] for _ in range(reps)]
    fulls = [wall(lambda: model.generate(rows, None, g33, adapters=route))[1] for _ in range(reps)]
    return (statistics.median(fulls) - statistics.median(firsts)) / 32 * 1e3


def _drop_graphs():
    """Drop every decode graph and hand the cached memory back to the card:
    each entry's pool, and what earlier phases left cached, would otherwise
    split the card's memory into pieces a later allocation cannot use."""
    gen_mod.clear_decode_graphs()
    gc.collect()
    torch.cuda.empty_cache()


def lora_step_costs(model, multi, singles, tag, batches):
    """ms a graphed decode step with the base tree, one adapter (a single-
    adapter model) and two stacked adapters routed [0, 1, ...], at each
    batch of `batches`, in turns in one process; one graph entry live at a
    time, with its memory beside it."""
    ids = [1] + list(range(400, 520))
    out = {}
    for b in batches:
        row, held = {}, {}
        for name, m, adapters in (("base", model, None), ("one adapter", singles[0], None),
                                  ("two stacked", multi, [0, 1]), ("base again", model, None)):
            _drop_graphs()
            row[name] = _decode_step_ms(m, ids, b, adapters=adapters)
            held[name] = torch.cuda.memory_allocated() / 2**30
        _drop_graphs()
        out[f"bs{b}"] = row
        log(f"[multi-lora {tag}] {_timing.smi_line()}: ms a graphed decode step at bs {b} "
            f"(121-token text prompt, 32 steps, medians of 2): "
            + ", ".join(f"{k} {v:.3f}" for k, v in row.items())
            + "; allocated with its graph entry " + ", ".join(f"{v:.3f}" for v in held.values())
            + " GiB")
    return out


def _check_adapter_rows(multi, singles, model, ids, frames, batch_ids, batch_frames, tag):
    """(b): prefill logits of `multi` on the 2-frame request and greedy
    tokens on the ragged batch of 4 with adapters all 0, all 1 and all -1,
    bit-equal to the single-adapter models' and the base model's at the
    same batch shapes, graphed; and the graph's tokens the eager loop's."""
    refs = {0: singles[0], 1: singles[1], -1: model}
    firsts, answers = {}, {}
    for a, ref in refs.items():
        got = _last_prefill_logits(multi, ids, frames, [a])
        want = _last_prefill_logits(ref, ids, frames)
        check(torch.equal(got, want), f"{tag}: adapter {a}'s prefill logits are not its model's")
        firsts[a] = int(got.argmax())
        graphed = multi.generate(batch_ids, batch_frames, G16, adapters=[a] * len(batch_ids))
        check(graphed == ref.generate(batch_ids, batch_frames, G16),
              f"{tag}: adapter {a}, batch of 4: graphed tokens are not its model's")
        with decode_loop(False):
            eager = multi.generate(batch_ids, batch_frames, G16, adapters=[a] * len(batch_ids))
        check(eager == graphed, f"{tag}: adapter {a}, batch of 4: graph against eager")
        answers[a] = graphed
        log(f"[{tag}] adapter {a}: the 2-frame request's prefill logits and the batch of 4's "
            f"greedy tokens bit-equal to its own model's, graphed and eager; first token "
            f"{firsts[a]}")
    check(answers[0] != answers[-1] != answers[1], f"{tag}: the adapters do not move the tokens")


def _one_entry_two_lists(multi, batch_ids, batch_frames, tag):
    """(c): one graph entry replayed with two adapter lists in turn; each
    run's tokens its eager run's."""
    lists = ([0, 1, -1, 0], [1, -1, 0, 1])
    with decode_loop(False):
        eager = [multi.generate(batch_ids, batch_frames, G16, adapters=ids) for ids in lists]
    gen_mod.clear_decode_graphs()
    for ids, want in zip(lists, eager):
        got = multi.generate(batch_ids, batch_frames, G16, adapters=ids)
        check(got == want, f"{tag}: adapters {ids}: graph tokens are not the eager run's")
    entries = gen_mod.decode_graphs()
    check(len(entries) == 1, f"{tag}: {len(entries)} graph entries for one key")
    log(f"[{tag}] one graph entry, adapter lists {lists[0]} and {lists[1]} in turn: "
        f"each run's tokens its eager run's; replays {entries[0].replays}, capture "
        f"{entries[0].capture_seconds:.3f} s; eager runs differ: {eager[0] != eager[1]}")


def _engine_adapters(multi, refs, requests, tag, **engine_kw):
    """(d): the engine over the stacked model with `requests` [(name, ids,
    frames, gen, adapter)] sent at once: each greedy token within
    SPEC_GAP_TOL of the teacher-forced maximum under its own adapter.
    Returns (results, the engine's stats, launches)."""
    from teochat_torch.serve.engine import BatchEngine

    engine = BatchEngine(multi, max_slots=8, max_len=2048, chunk=8, prefill_chunk=256,
                         prefix_cache_slots=2, prefix_min_tokens=256, **engine_kw)
    adapters = {name: a for name, *_, a in requests}
    try:
        (results, counts) = counted(tag, lambda: _serve_named(
            engine, [r[:4] for r in requests], adapters=adapters))
        stats = dict(engine.stats)
    finally:
        engine.shutdown()
    del engine
    _drop_graphs()
    worst = {}
    for name, ids, frames, gen, a in requests:
        toks = results[name][0]
        check(toks and len(toks) <= gen.max_new_tokens, f"{tag} {name}: {len(toks)} tokens")
        if gen.do_sample:
            continue
        gaps, _ = teacher_forced_gaps(refs[a], ids, frames, toks)
        worst[name] = max(gaps)
        check(worst[name] <= SPEC_GAP_TOL,
              f"{tag} {name} (adapter {a}): a greedy token {worst[name]:.3f} rms below its maximum")
    log(f"[{tag}] 8 requests over adapters {sorted(set(adapters.values()))}: the largest gap "
        f"of each greedy request to its adapter's teacher-forced maximum (rms) "
        + ", ".join(f"{n} {g:.3f}" for n, g in worst.items()) + f"; stats {stats}")
    return results, stats, counts


def _engine_tok_s(model, adapters, tag, runs=2):
    """Aggregate tok/s of 8 text streams of 121 + 64 tokens through one
    engine, each stream routed by `adapters` (None: the plain model)."""
    from teochat_torch.serve.engine import BatchEngine

    gen = GenerationConfig(max_new_tokens=64, temperature=0.0, do_sample=False, stop_strings=())
    prompts = [[1] + list(range(10 + i, 130 + i)) for i in range(8)]
    engine = BatchEngine(model, max_slots=8, max_len=512, chunk=8).start()
    try:
        engine.submit(prompts[0], None, gen, adapter=-1 if adapters is None else adapters[0])
        out = [None] * 8

        def round_():
            threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, engine.submit(
                prompts[i], None, gen, adapter=-1 if adapters is None else adapters[i])))
                for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

        secs = [wall(round_)[1] for _ in range(runs)]
    finally:
        engine.shutdown()
    del engine
    _drop_graphs()
    rates = [sum(len(o) for o in out) / s for s in secs]
    log(f"[{tag}] 8 streams of 121 + 64 tokens: " + ", ".join(f"{r:.2f}" for r in rates)
        + " tok/s")
    return rates


def _branch_a(root, base_path, adapter_dir, tokenizer, image_processor, single):
    """(f): a `teochat-lora` dir over the base checkpoint (its config and
    tokenizer, one adapter dir's peft files, non_lora_trainables.bin with a
    projector of its own) loaded with load_8bit through branch A; the load's
    seconds and the card's peak, one request (its tokens beside the
    unmerged single-adapter model's, where they first differ)."""
    from teochat_torch.builder import load_pretrained_model

    path = os.path.join(root, "teochat-lora-7b")
    os.makedirs(path)
    for name in ("config.json", "tokenizer.json", "tokenizer_config.json"):
        shutil.copy(os.path.join(base_path, name), path)
    for name in ("adapter_model.safetensors", "adapter_config.json"):
        shutil.copy(os.path.join(adapter_dir, name), path)
    cfg = single.cfg
    g = torch.Generator().manual_seed(SEED + 7)
    m, d = cfg.projector.mm_hidden_size, cfg.projector.hidden_size
    nlt = {"model.mm_projector.0.weight": torch.randn(d, m, generator=g) * 0.02,
           "model.mm_projector.0.bias": torch.zeros(d),
           "model.mm_projector.2.weight": torch.randn(d, d, generator=g) * 0.02,
           "model.mm_projector.2.bias": torch.zeros(d)}
    torch.save({"base_model.model." + k: v.half() for k, v in nlt.items()},
               os.path.join(path, "non_lora_trainables.bin"))
    gc.collect()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rss_before = _peak_rss_gib()
    (_, merged, _, _), load_s = wall(lambda: load_pretrained_model(path, base_path,
                                                                   load_8bit=True))
    tree = _tree_bytes(merged.params)
    peak = torch.cuda.max_memory_allocated() - before
    log(f"[multi-lora branch A] load_pretrained_model(teochat-lora dir, base, load_8bit=True): "
        f"{load_s:.2f} s; the process's peak RSS {_peak_rss_gib():.3f} GiB ({rss_before:.3f} before); "
        f"card: loaded tree {tree / 2**30:.3f} GiB, peak during the load {peak / 2**30:.3f} GiB "
        f"above the {before / 2**30:.3f} GiB held before")
    check(peak < tree + CKPT_LOAD_HEADROOM,
          f"branch A: the load's peak {peak} is not below the tree {tree} + 3 GiB")
    check(merged.params["llm"]["layers"]["attn"]["q"]["kernel"].dtype == torch.int8,
          "branch A: int8 decoder")
    want_proj = nlt["model.mm_projector.0.weight"].half().T.to("cuda", torch.bfloat16)
    check(torch.equal(merged.params["projector"]["layers"][0]["kernel"], want_proj),
          "branch A: the projector is not non_lora_trainables.bin's")
    frames = image_processor.preprocess(
        [np.random.RandomState(SEED + 8).randint(0, 256, (300, 400, 3), dtype=np.uint8)
         for _ in range(2)])["pixel_values"]
    ids = tokenizer_image_token(PROMPT_2.replace("<video>", "Image 1: <image> Image 2: <image>"),
                                tokenizer, IMAGE_TOKEN_INDEX)
    g32 = GenerationConfig(max_new_tokens=32, temperature=0.0, do_sample=False, stop_strings=())
    (out, sec), counts = counted("multi-lora branch A", lambda: wall(
        lambda: merged.generate([ids], frames, g32)[0]))
    check(out and all(0 <= t < cfg.llm.vocab_size for t in out), "branch A: the answer")
    check(all(counts[k] > 0 for k in ("K1", "K2", "K5")), f"branch A launches {counts}")
    # the unmerged adapter over the int8 base, with the dir's projector: what
    # differs is the int8 rounding of W + delta against that of W
    twin = teochat_mod.TEOChat(cfg, {**single.params, "projector": merged.params["projector"]},
                               tokenizer=single.tokenizer)
    unmerged = twin.generate([ids], frames, g32)[0]
    gaps, _ = teacher_forced_gaps(twin, ids, frames, out)
    log(f"[multi-lora branch A] one 2-frame request: {sec:.3f} s, {len(out)} tokens; the "
        f"unmerged adapter over the int8 base (the same projector) first differs at "
        f"{_first_difference(out, unmerged)}, the merged tokens' largest gap to its "
        f"teacher-forced maximum {max(gaps):.3f} rms (printed: the two round W + delta to "
        f"int8 differently)")
    del merged
    gc.collect()
    torch.cuda.empty_cache()
    return {"load_s": load_s, "peak_gib": peak / 2**30, "tree_gib": tree / 2**30,
            "request_s": sec}


def phase_multi_lora(model, tokenizer, image_processor, root, ids, frames, gen):
    """Multi-LoRA and LoRA checkpoints on the loaded int8 7B model: (a) two
    peft dirs at full width (r 128, alpha 256, A and B from the seed)
    loaded by `load_multi_lora`; (b) adapters all 0, all 1, all -1 bit-equal
    to their own models, graphed and eager; (c) one graph entry for two
    adapter lists; (d) the engine, plain and speculative (k 4), with 8
    requests over adapters {-1, 0, 1} held to their adapters' teacher-forced
    maxima, and a prefix hit refused across adapters; (e) ms a graphed
    decode step with the base, one adapter and two stacked (bs 8), the
    engine's tok/s mixed against base; (f) branch A. Returns its
    numbers and the dirs (phase 14 times int4 with them)."""
    from teochat_torch.builder import load_multi_lora

    t0 = time.perf_counter()
    _drop_graphs()
    cfg = model.cfg
    dirs = [os.path.join(root, f"adapter-{i}") for i in range(2)]
    nbytes = sum(write_peft_dir(d, cfg, gen) for d in dirs)
    gc.collect()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    multi, sec = wall(lambda: load_multi_lora(model, dirs))
    lora_gib = _lora_bytes(multi.params["llm"]) / 2**30
    peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    log(f"[multi-lora] wrote 2 peft dirs (r {LORA_RANK}, alpha {LORA_ALPHA:g}, fp16, "
        f"{nbytes} bytes); load_multi_lora: {sec:.2f} s, the stacked fp32 adapters "
        f"{lora_gib:.3f} GiB on the card, peak {peak:.3f} GiB above the {before / 2**30:.3f} "
        f"GiB held before; {_timing.smi_line()}")
    check(multi.params["llm"]["layers"]["attn"]["q"]["kernel"] is
          model.params["llm"]["layers"]["attn"]["q"]["kernel"], "the backbone is not shared")
    singles = [_single_adapter_model(model, d) for d in dirs]
    refs = {0: singles[0], 1: singles[1], -1: model}
    processor = FrameProcessor(cfg.vision.image_size, SEED)
    batch_ids, batch_frames = ragged_batch(tokenizer, processor)

    marks = {"(a)": time.perf_counter()}

    def paths():
        _check_adapter_rows(multi, singles, model, ids, frames, batch_ids, batch_frames,
                            "multi-lora")
        _one_entry_two_lists(multi, batch_ids, batch_frames, "multi-lora")

    _, path_counts = counted("multi-lora generate", paths)
    check(all(path_counts[k] > 0 for k in ("K1", "K2", "K5")),
          f"multi-lora generate launches {path_counts}")
    _drop_graphs()

    marks["(b), (c)"] = time.perf_counter()
    rs = np.random.RandomState(SEED + 5)
    requests = []
    for i, (name, rids, rframes, rgen) in enumerate(
            _engine_prompts(tokenizer, image_processor, rs)):
        if rgen is None:  # the stop-string request of phase 13: greedy here
            rgen = GenerationConfig(max_new_tokens=32, temperature=0.0, do_sample=False,
                                    stop_strings=())
        adapter = {"prefix miss": 0, "prefix hit": 1}.get(name, (-1, 0, 1)[i % 3])
        requests.append((name, rids, rframes, rgen, adapter))
    plain, plain_stats, plain_counts = _engine_adapters(multi, refs, requests,
                                                        "multi-lora engine")
    check(plain_stats["prefix_hits"] == 0, f"a prefix hit across adapters: {plain_stats}")
    check(all(plain_counts[k] > 0 for k in ("K1", "K2", "K2m", "K5")),
          f"multi-lora engine launches {plain_counts}")
    same = [(n, i, f, g, 0) for n, i, f, g, _ in requests if n.startswith("prefix")]
    _, hit_stats, _ = _engine_adapters(multi, refs, same, "multi-lora engine same adapter")
    check(hit_stats["prefix_hits"] == 1, f"no prefix hit within one adapter: {hit_stats}")
    spec, spec_stats, spec_counts = _engine_adapters(multi, refs, requests,
                                                     "multi-lora engine spec", speculative_k=4,
                                                     adaptive_spec=False)
    check(spec_counts["K2"] == 0 and spec_counts["K2m"] > 0,
          f"multi-lora spec engine launches {spec_counts}")
    _drop_graphs()

    marks["(d)"] = time.perf_counter()
    costs = lora_step_costs(model, multi, singles, "int8", batches=(8,))
    mixed = [(-1, 0, 1)[i % 3] for i in range(8)]
    tok_s = {"base": _engine_tok_s(model, None, "multi-lora engine base", runs=1),
             "mixed": _engine_tok_s(multi, mixed, f"multi-lora engine mixed {mixed}", runs=1)}
    _drop_graphs()
    marks["(e)"] = time.perf_counter()
    branch_a = _branch_a(root, os.path.join(root, "TEOChat-7B"), dirs[0], tokenizer,
                         image_processor, singles[0])
    del multi, singles, refs
    _drop_graphs()
    marks["(f)"] = time.perf_counter()
    sec = time.perf_counter() - t0
    ends = list(marks.values())
    parts = {name: end - start for name, start, end in zip(marks, [t0] + ends, ends)}
    log(f"[multi-lora] the phase took {sec:.1f} s: "
        + ", ".join(f"{name} {v:.1f}" for name, v in parts.items()))
    return {"adapters_gib": lora_gib, "load_peak_gib": peak, "step_ms": costs,
            "engine_tok_s": tok_s, "branch_a": branch_a, "generate_launches": path_counts,
            "engine_launches": plain_counts, "spec_engine_launches": spec_counts,
            "phase_s": sec, "part_s": parts}, dirs


def phase_multi_lora_int4(model, dirs):
    """(e) at int4: ms a graphed decode step at bs 8 with the base, one
    adapter and two stacked, over the fused int4 model (block-composed
    adapters of rank 3r / 2r)."""
    from teochat_torch.builder import load_multi_lora

    multi = load_multi_lora(model, dirs)
    check(multi.params["llm"]["layers"]["attn"]["qkv"]["lora_a"].shape[-1] == 3 * LORA_RANK,
          "int4: the block-composed q|k|v adapter")
    singles = [_single_adapter_model(model, d) for d in dirs]
    out, counts = counted("multi-lora int4", lambda: lora_step_costs(
        model, multi, singles, "int4", batches=(8,)))
    check(counts["K3c M<=8"] > 0, f"multi-lora int4 launches {counts}")
    del multi, singles
    _drop_graphs()
    return out


def phase_checkpoint_int4(root, lora_dirs):
    """The same checkpoint loaded with load_int4: one 2-frame request of uint8
    frames, then the engine (phase_engine_int4), then the multi-LoRA step
    costs over it (`lora_dirs`). Returns the request's launches, the
    engine's chunk times and the LoRA step costs."""
    from teochat_torch.builder import load_pretrained_model

    path = os.path.join(root, "TEOChat-7B")
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (tokenizer, model, processor, _), sec = wall(lambda: load_pretrained_model(path, load_int4=True))
    tree = _tree_bytes(model.params)
    peak = torch.cuda.max_memory_allocated() - before
    log(f"[checkpoint int4] load_pretrained_model(load_int4=True): {sec:.2f} s; loaded tree "
        f"{tree / 2**30:.3f} GiB, peak during the load {peak / 2**30:.3f} GiB above what was held")
    check("qkv" in model.params["llm"]["layers"]["attn"], "fused int4 q|k|v")
    frames = eval_dataset(SEED + 1)[0]["video"]

    def request():
        return wall(lambda: run_inference_single(
            model, processor["image"], tokenizer, PROMPT_2, frames,
            timestamps=["2019-03-15", "2019-01-15"], temperature=0.0, max_new_tokens=32))

    (answer, sec), counts = counted("checkpoint int4", request)
    log(f"[checkpoint int4] 2-frame request: {sec:.3f} s answer={answer[:120]!r}")
    check(isinstance(answer, str) and answer, "checkpoint int4: empty answer")
    check(all(counts[k] > 0 for k in ("K1", "K2", "K3b", "K3c M<=8", "K5"))
          and counts["K3c"] > counts["K3c M<=8"], f"checkpoint int4 launches {counts}")
    return {"request_launches": counts, "engine_chunks": phase_engine_int4(model),
            "multi_lora_step_ms": phase_multi_lora_int4(model, lora_dirs)}


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

    for counter in (flash_mod.FWD_RES_LAUNCHES, flash_mod.BWD_DKV_LAUNCHES,
                    flash_mod.BWD_DQ_LAUNCHES):
        counter.reset()
    results, main_counts = counted("bench main", lambda: bench_main.main(
        ["--phases", "encode", "e2e", "train", "train_bf16"]))
    k4 = _k4_counts()
    check(all(main_counts[k] > 0 for k in ("K1", "K2", "K5")) and min(k4.values()) > 0,
          f"bench main launches {main_counts}, K4 {k4}")
    keys = ("encode_frames_per_sec", "xbd_2frame_e2e_latency_s_32newtok", "train_tokens_per_sec",
            "train_mfu", "train_tokens_per_sec_accum8", "train_mfu_accum8",
            "train_tokens_per_sec_bf16full_1b", "train_mfu_bf16full_1b")
    for key in keys:
        check(np.isfinite(results[key]) and results[key] > 0, f"bench main: {key}")
    train_keys = {k: results[k] for k in keys[2:]}
    log(f"[bench] train keys: {json.dumps(train_keys)}; {results['smi']}")
    return counts, train_keys


# ------------------------------------------------- the vision extras (w8a8, towers, tokens)

# the w8a8 products' shapes (name, M, K, N): the tower's at an encode of 32
# frames of 257 tokens (q, k, v and out; fc1; fc2), the 7B prefill's of 640
# tokens (q, k, v and out; gate and up; down: the int8 tree keeps them
# unfused), and a suffix of 5 rows, which torch._int_mm on the card takes only
# padded to 17
W8A8_SHAPES = [("tower q|k|v|out", 32 * 257, 1024, 1024), ("tower fc1", 32 * 257, 1024, 4096),
               ("tower fc2", 32 * 257, 4096, 1024), ("prefill q|k|v|out", 640, 4096, 4096),
               ("prefill gate|up", 640, 4096, 11008), ("prefill down", 640, 11008, 4096),
               ("suffix q|k|v|out", 5, 4096, 4096)]
# the w8a8 tower's vision tokens against the bf16 tower's on the same
# frames: per-token int8 activations through 23 layers keep the tokens
# close, not equal (the JAX package's own tests hold its w8a8 tower to 5e-2
# of the largest hidden state and a cosine above 0.999)
W8A8_TOWER_REL_L2 = 5e-2
W8A8_TOWER_COS = 0.99


def phase_w8a8_projections(gen):
    """(a) The w8a8 projection at the tower's, the 7B prefill's and a short
    suffix's shapes: the int8 activations equal the CPU's quantization of the
    same bf16 rows, and the int32 sums of `int8_matmul` (torch._int_mm, rows
    padded below 17) equal the exact product (fp64 on the card), bit for
    bit, from the decoder's row-major [K, N] weight and from a `k_major`
    one; ms of the w8a8 projection (quantize, product, scale) on the weight
    as its tree stores it (the tower's `k_major`, the decoder's row-major),
    of the int8 product alone (from the row-major weight, which
    `int8_matmul` copies to column-major first, and from the `k_major`
    weight), beside the w8a16 projection and a bf16 `torch.matmul` at the
    same shape, and the int8 bound."""
    rows = {}
    for name, m, k, n in W8A8_SHAPES:
        x = (torch.randn(m, k, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        p = quant_mod.quantize_kernel(torch.randn(k, n, generator=gen, device="cuda") * 0.02)
        x_i8, scale_x = quant_mod.quantize_rows_i8(x)
        want_i8, want_sx = quant_mod.quantize_rows_i8(x.cpu())
        check(torch.equal(x_i8.cpu(), want_i8) and torch.equal(scale_x.cpu(), want_sx),
              f"w8a8 {name}: the int8 activations differ from the CPU's")
        col_major = quant_mod.k_major(p["kernel"])
        exact = x_i8.double() @ p["kernel"].double()  # |sum| < 2^31: exact in fp64
        for w in (p["kernel"], col_major):
            acc = quant_mod.int8_matmul(x_i8, w)
            check(torch.equal(acc.double(), exact), f"w8a8 {name}: the int32 sums are not exact")
        tree_p = {**p, "kernel": col_major} if name.startswith("tower") else p
        y = quant_mod.quantized_proj_act_i8(x, tree_p)
        check(tuple(y.shape) == (m, n) and torch.isfinite(y).all().item(), f"w8a8 {name}: output")
        w_bf16 = quant_mod.dequantize_kernel(p, torch.bfloat16)
        ms = time_ms(lambda: quant_mod.quantized_proj_act_i8(x, tree_p))
        mm_ms = time_ms(lambda: quant_mod.int8_matmul(x_i8, p["kernel"]))
        col_ms = time_ms(lambda: quant_mod.int8_matmul(x_i8, col_major))
        w8a16_ms = time_ms(lambda: quant_mod.quantized_proj(x, p))
        bf16_ms = time_ms(lambda: torch.matmul(x, w_bf16))
        bound, by = bound_ms(2 * m * k + k * n + 4 * n + 2 * m * n, 2 * m * k * n,
                             _timing.INT8_OPS_PER_S)
        log(f"[w8a8 a] {name} M={m} K={k} N={n}: int8 activations and int32 sums exact; ms "
            f"w8a8 {ms:.4f} on the tree's "
            f"{'k_major' if tree_p is not p else 'row-major'} weight (the int8 product on a "
            f"row-major weight with its copy {mm_ms:.4f}, on a k_major weight {col_ms:.4f}: "
            f"{2 * m * k * n / col_ms / 1e9:.1f} TOP/s), w8a16 "
            f"{w8a16_ms:.4f}, bf16 matmul "
            f"{bf16_ms:.4f}; int8 bound {bound:.4f} ({by})")
        rows[name] = {"m": m, "k": k, "n": n, "w8a8_ms": ms, "int_mm_ms": mm_ms,
                      "int_mm_col_major_ms": col_ms, "w8a16_ms": w8a16_ms, "bf16_ms": bf16_ms,
                      "bound_ms": bound, "bound_by": by}
    return rows


def phase_w8a8_tower(gen):
    """(b) 32 frames through the full ViT-L/14 tower and the projector, bf16
    and after `quantize_vit_params`: the vision tokens' relative L2 and
    cosine, K5's and the int8 products' launches in the w8a8 encode, and
    frames/s both ways (in turns, medians of 3 batches of 5)."""
    cfg = TEOChatConfig()
    enc = init_encoder(cfg, gen, "cuda", torch.bfloat16)
    w8 = {**enc, "vision": quant_mod.quantize_vit_params(enc["vision"])}
    frames = torch.randn(32, 3, 224, 224, generator=gen, device="cuda").to(torch.bfloat16)
    layers = cfg.vision.num_layers - 1  # select_layer -2
    with torch.no_grad():
        want = teochat_mod.encode_frames(enc, cfg, frames)
        vit_mod.LAUNCHES.reset()
        quant_mod.ACT_I8_PRODUCTS.reset()
        got = teochat_mod.encode_frames(w8, cfg, frames)
        sync()
        k5, products = vit_mod.LAUNCHES.count, quant_mod.ACT_I8_PRODUCTS.count
        times = {"bf16": [], "w8a8": []}
        for params, key in ((enc, "bf16"), (w8, "w8a8"), (w8, "w8a8"), (enc, "bf16")):
            times[key].append(_timing.timeit(
                lambda: teochat_mod.encode_frames(params, cfg, frames), 5, "cuda"))
    diff = (got.float() - want.float()).norm() / want.float().norm()
    cos = F.cosine_similarity(got.float().flatten(), want.float().flatten(), dim=0)
    fps = {key: 32 / statistics.median(t) for key, t in times.items()}
    log(f"[w8a8 b] 32 frames through ViT-L/14 and the projector, w8a8 against bf16: vision "
        f"tokens rel L2 {diff.item():.3e} (bound {W8A8_TOWER_REL_L2}), cosine {cos.item():.5f}; "
        f"K5 {k5} launches, {products} int8 products (6 a layer of {layers}); frames/s w8a8 "
        f"{fps['w8a8']:.1f} against bf16 {fps['bf16']:.1f} (x{fps['w8a8'] / fps['bf16']:.3f}); "
        f"{_timing.smi_line()}")
    check(tuple(got.shape) == tuple(want.shape) and torch.isfinite(got).all().item(),
          "w8a8 tower output")
    check(diff.item() <= W8A8_TOWER_REL_L2 and cos.item() >= W8A8_TOWER_COS,
          f"w8a8 tower tokens rel L2 {diff.item()}, cosine {cos.item()}")
    check(k5 == layers and products == 6 * layers, f"w8a8 tower: K5 {k5}, products {products}")
    del enc, w8
    return {"tokens_rel_l2": diff.item(), "cosine": cos.item(), "k5_launches": k5,
            "frames_per_sec_w8a8": fps["w8a8"], "frames_per_sec_bf16": fps["bf16"]}


def phase_towers(gen):
    """(e) The audio tower (126 x 1036 spectrograms: 9 x 74 patches and CLS,
    S 667 through K5) and the video tower (8 frames, temporal attention) at
    full width, random weights from the seed: finite features of the
    expected shapes, K5 launching; then K5 at the audio tower's shape
    against its plain version (VIT_TOL) and timed beside it and SDPA."""
    from teochat_torch.models.towers import build_video_tower, build_vision_tower

    audio = build_vision_tower("LanguageBind/LanguageBind_Audio").load_model(
        rng=gen, device="cuda", dtype=torch.bfloat16)
    s, layers = audio.cfg.num_positions, audio.cfg.num_layers - 1
    check(s == 667 and vit_mod.in_kernel_range(s), f"audio tower S {s}")
    spec = torch.randn(2, 3, 126, 1036, generator=gen, device="cuda").to(torch.bfloat16)
    vit_mod.LAUNCHES.reset()
    with torch.no_grad():
        feats, audio_s = wall(lambda: audio(spec))
    k5_audio = vit_mod.LAUNCHES.count
    check(tuple(feats.shape) == (2, 666, 1024) and torch.isfinite(feats).all().item(),
          f"audio tower features {tuple(feats.shape)}")
    check(k5_audio == layers, f"audio tower K5 launches {k5_audio}")
    del audio

    b, h, d = 2, 16, 64
    q, k, v = (_randn((b, s, h, d), gen) for _ in range(3))
    got = vit_mod.vit_attention(q, k, v)
    sync()
    want = vit_mod.vit_attention_plain(q.float(), k.float(), v.float())
    err = (got.float() - want).abs().max().item()
    check(err <= VIT_TOL, f"K5 at S {s}: error {err} > {VIT_TOL}")
    ms = time_ms(lambda: vit_mod.vit_attention(q, k, v))
    plain_ms = time_ms(lambda: vit_mod.vit_attention_plain(q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(_bhsd(q), _bhsd(k), _bhsd(v)))
    row = kernel_row(err, ms, plain_ms, 2 * 4 * b * s * h * d, 4 * b * h * s * s * d, lib_ms)

    video = build_video_tower().load_model(rng=gen, device="cuda", dtype=torch.bfloat16)
    clip = torch.randn(1, 8, 3, 224, 224, generator=gen, device="cuda").to(torch.bfloat16)
    vit_mod.LAUNCHES.reset()
    with torch.no_grad():
        vfeats, video_s = wall(lambda: video.encode_videos(clip))
    k5_video = vit_mod.LAUNCHES.count
    check(tuple(vfeats.shape) == (1, 8, 256, 1024) and torch.isfinite(vfeats).all().item(),
          f"video tower features {tuple(vfeats.shape)}")
    check(k5_video == layers, f"video tower K5 launches {k5_video}")
    del video
    log(f"[towers e] audio tower, 2 spectrograms of 126 x 1036 (S {s}): features (2, 666, 1024) "
        f"in {audio_s * 1e3:.2f} ms, K5 {k5_audio} launches; K5 at [{b},{s},{h},{d}] "
        f"max_abs_err {err:.3e} (tol {VIT_TOL}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
        f"scaled_dot_product_attention {lib_ms:.4f} ms bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}); video tower, 8 frames: features (1, 8, 256, 1024) in "
        f"{video_s * 1e3:.2f} ms (the temporal attention over 8 frames on the plain attention), "
        f"K5 {k5_video} launches")
    return {"audio_s": audio_s, "video_s": video_s, "k5_launches_audio": k5_audio,
            "k5_launches_video": k5_video, "k5_s667": row}


def phase_w8a8_prefill(model, tokenizer, ids, frames):
    """(c) The loaded 8-bit TEOChat-7B with `int8_prefill_activations` (the
    same params, no reload): the 2-frame request's TTFT beside the w8a16
    prefill's, in turns in one process (medians of 5); its greedy tokens
    each within SPEC_GAP_TOL of its position's largest logit in a
    teacher-forced w8a16 prefill (the decode steps are w8a16); K1 and the
    int8 products counted (one a projection of the prefill, none in the
    decode graph); a session's turn 2 (its suffix prefill w8a8) and an
    engine request, each replaying its decode graph."""
    from teochat_torch.serve.engine import BatchEngine
    from teochat_torch.serve.session import ChatSession

    cfg = model.cfg
    w8 = teochat_mod.TEOChat(dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, int8_prefill_activations=True)), model.params, tokenizer=model.tokenizer)
    layers = cfg.llm.num_layers
    g1 = GenerationConfig(max_new_tokens=1, temperature=0.0, do_sample=False, stop_strings=())
    g32 = dataclasses.replace(g1, max_new_tokens=32)
    ttft = {"w8a16": [], "w8a8": []}
    for m in (model, w8):
        m.generate([ids], frames, g1)
    for _ in range(5):
        for key, m in (("w8a16", model), ("w8a8", w8)):
            ttft[key].append(wall(lambda: m.generate([ids], frames, g1))[1])
    med = {key: statistics.median(t) for key, t in ttft.items()}
    quant_mod.ACT_I8_PRODUCTS.reset()
    out, counts = counted("w8a8 c", lambda: w8.generate([ids], frames, g32)[0])
    products = quant_mod.ACT_I8_PRODUCTS.count
    plain = model.generate([ids], frames, g32)[0]
    gaps, _ = teacher_forced_gaps(model, ids, frames, out)
    gaps8, _ = teacher_forced_gaps(w8, ids, frames, out)
    log(f"[w8a8 c] 2-frame bs1 TTFT (encode + fuse + prefill + first token; medians of 5 in "
        f"turns): w8a8 {med['w8a8'] * 1e3:.2f} ms against w8a16 {med['w8a16'] * 1e3:.2f} ms "
        f"(x{med['w8a16'] / med['w8a8']:.3f}); {_timing.smi_line()}")
    log(f"[w8a8 c] greedy 32 tokens: K1 {counts['K1']} launches, {products} int8 products "
        f"({7 * layers} in the prefill); first difference from the w8a16 path at "
        f"{_first_difference(out, plain)}; largest gap to the teacher-forced maximum "
        f"{max(gaps):.3e} rms over a w8a16 prefill, {max(gaps8):.3e} over a w8a8 one "
        f"(bound {SPEC_GAP_TOL})")
    check(counts["K1"] == layers and counts["K2"] > 0 and products == 7 * layers,
          f"w8a8 c: K1 {counts['K1']}, int8 products {products}")
    check(max(gaps) <= SPEC_GAP_TOL, f"w8a8 c: a token {max(gaps)} rms below its maximum")

    # a session's second turn: the suffix prefill w8a8, its decode replayed
    session = ChatSession(w8, max_len=1024)
    g8 = dataclasses.replace(g1, max_new_tokens=8)
    first = session.generate(ids, frames, g8)
    turn2 = list(ids) + list(first) + list(range(300, 340))
    quant_mod.ACT_I8_PRODUCTS.reset()
    second = session.generate(turn2, frames, g8)
    suffix_products = quant_mod.ACT_I8_PRODUCTS.count
    replays = sum(g.replays for g in gen_mod.decode_graphs())
    check(len(second) == 8 and suffix_products == 7 * layers and replays > 0,
          f"w8a8 c: session turn 2 {suffix_products} int8 products, {replays} replays")
    del session
    gen_mod.clear_decode_graphs()

    # an engine request: a w8a8 prefill, the engine's own graph replayed
    engine = BatchEngine(w8, max_slots=2, max_len=1024, chunk=8).start()
    quant_mod.ACT_I8_PRODUCTS.reset()
    try:
        e_out = engine.submit(ids, frames, dataclasses.replace(g1, max_new_tokens=16))
        e_products = quant_mod.ACT_I8_PRODUCTS.count
        e_replays = engine._graph.replays
    finally:
        engine.shutdown()
    e_gaps, _ = teacher_forced_gaps(model, ids, frames, e_out)
    log(f"[w8a8 c] a session's turn 2 ({len(turn2)} ids, the suffix prefilled w8a8): "
        f"{suffix_products} int8 products, its decode graph replayed {replays} times; an engine "
        f"request of 16 tokens: {e_products} int8 products, the engine's graph replayed "
        f"{e_replays} times, largest gap {max(e_gaps):.3e} rms")
    check(e_products == 7 * layers and e_replays > 0 and max(e_gaps) <= SPEC_GAP_TOL,
          f"w8a8 c: engine {e_products} int8 products, {e_replays} replays, gap {max(e_gaps)}")
    return {"ttft_s_w8a8": med["w8a8"], "ttft_s_w8a16": med["w8a16"],
            "k1_launches": counts["K1"], "int8_products": products,
            "largest_gap_rms": max(gaps)}


def phase_vision_tokens(root, path, load_entry):
    """(d) The smoke's 7B checkpoint with `mm_use_im_start_end` and
    `mm_use_im_patch_token` in its config (the same shards and tokenizer,
    linked): `eval.load_model(load_8bit=True)` adds the five vision tokens
    to the tokenizer and grows the embedding and the lm_head by their mean
    before the int8 quantization (seconds, the card's peak beside phase
    10's); one `eval()` example, whose prompt wraps each frame's <image> in
    <im_start> / <im_end>."""
    from teochat_torch.eval import eval as eval_mod
    from teochat_torch.eval.inference import _build_prompt

    imse = os.path.join(root, "TEOChat-7B-imse")
    os.makedirs(imse)
    for name in os.listdir(path):
        if name != "config.json":
            os.symlink(os.path.abspath(os.path.join(path, name)), os.path.join(imse, name))
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    hf.update(mm_use_im_start_end=True, mm_use_im_patch_token=True)
    with open(os.path.join(imse, "config.json"), "w") as f:
        json.dump(hf, f)
    gc.collect()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (tok, m, proc), load_s = wall(lambda: eval_mod.load_model(imse, load_8bit=True))
    peak = torch.cuda.max_memory_allocated() - before
    tree = _tree_bytes(m.params)
    n = len(tok)
    llm = m.params["llm"]
    log(f"[vision tokens d] eval.load_model(mm_use_im_start_end, mm_use_im_patch_token, "
        f"load_8bit=True): {load_s:.2f} s (phase 10's load {load_entry['load_s']:.2f} s); card: "
        f"tree {tree / 2**30:.3f} GiB, peak during the load {peak / 2**30:.3f} GiB (phase 10's "
        f"{load_entry['load_peak_gib']:.3f}); tokenizer {n} tokens, embedding "
        f"{tuple(llm['embed_tokens']['embedding'].shape)}, int8 lm_head "
        f"{tuple(llm['lm_head']['kernel'].shape)}")
    check(n == hf["vocab_size"] + 5 and m.cfg.llm.vocab_size == n
          and llm["embed_tokens"]["embedding"].shape[0] == n
          and tuple(llm["lm_head"]["kernel"].shape) == (hf["hidden_size"], n)
          and llm["lm_head"]["kernel"].dtype == torch.int8, "vision tokens: the grown vocab")
    check(peak < tree + CKPT_LOAD_HEADROOM, f"vision tokens: the load's peak {peak}")
    prompt = _build_prompt(EVAL_QUESTION, ["a", "b"], "v1", ["2019-01-01", "2019-02-01"],
                           "interleave", True, mm_use_im_start_end=True)[0]
    ids = tokenizer_image_token(prompt, tok, IMAGE_TOKEN_INDEX)
    start, end = tok.convert_tokens_to_ids("<im_start>"), tok.convert_tokens_to_ids("<im_end>")
    at = [i for i, t in enumerate(ids) if t == IMAGE_TOKEN_INDEX]
    check(len(at) == 2 and all(ids[i - 1] == start and ids[i + 1] == end for i in at),
          "vision tokens: the prompt's wrap")
    dataset = eval_dataset(SEED)[:1]
    (metrics, eval_s), counts = counted("vision tokens d", lambda: wall(lambda: eval_mod.eval(
        "fmow_high_res", model_path=imse, dataset=dataset, model_bundle=(tok, m, proc),
        out_dir=os.path.join(root, "eval_imse"), temperature=0.0, max_new_tokens=16)))
    check(all(counts[k] > 0 for k in ("K1", "K2", "K5")), f"vision tokens eval {counts}")
    log(f"[vision tokens d] eval('fmow_high_res') of one example: {eval_s:.3f} s, metrics "
        f"{metrics}; the prompt's two <image> each between <im_start> ({start}) and <im_end> "
        f"({end})")
    del m, llm
    gc.collect()
    torch.cuda.empty_cache()
    return {"load_s": load_s, "peak_gib": peak / 2**30, "tree_gib": tree / 2**30,
            "eval_s": eval_s, "vocab": n}


# ------------------------------------------------- phase 22: the MPT backend

def _alibi_table(h, s):
    """MPT-7B's ALiBi table for a MPT_TABLE_SLOTS-slot cache (32 heads,
    alibi_bias_max 8), its first H heads and S keys: a row-strided view, as
    mpt_forward slices it for a prefill."""
    return mpt_mod.alibi_bias(32, MPT_TABLE_SLOTS, device="cuda")[0, :h, 0, :s]


def phase_mpt_kernels(gen):
    """(a) K1's bias branch against its plain twin on the card: MPT-7B's
    2-frame prefill shape with a 4,096-slot table (reported in the JSON
    line), the multiquery case (one kv head, 32 slopes) and a ragged S; ms
    beside the bias-free K1 on the same inputs in this call, the plain
    twin, and scaled_dot_product_attention with a float mask holding the
    causal -inf and the bias (materialized [1, H, S, T], in bf16, each row
    shifted by its diagonal key's bias); K4a's o, m and l with the bias
    against flash_statistics_plain. Returns (the row, extra numbers)."""
    cases = [(1, 768, 32, 32, 128), (1, 768, 32, 1, 128), (1, 700, 32, 32, 128)]
    worst, main, extra = 0.0, None, {}
    for b, s, h, hkv, d in cases:
        q, k, v = _randn((b, s, h, d), gen), _randn((b, s, hkv, d), gen), _randn((b, s, hkv, d), gen)
        bias = _alibi_table(h, s)
        got = flash_mod.flash_attention(q, k, v, bias_k=bias)
        sync()
        want = flash_mod.flash_attention_plain(q.float(), k.float(), v.float(), bias_k=bias)
        err = (got.float() - want).abs().max().item()
        check(torch.isfinite(got).all().item(), "K1 bias output finite")
        ms = time_ms(lambda: flash_mod.flash_attention(q, k, v, bias_k=bias))
        nobias_ms = time_ms(lambda: flash_mod.flash_attention(q, k, v))
        plain_ms = time_ms(lambda: flash_mod.flash_attention_plain(q, k, v, bias_k=bias))
        flops = 4 * b * h * s * s * d / 2
        log(f"[K1 bias] B={b} S={s} H={h} Hkv={hkv} D={d} table of {MPT_TABLE_SLOTS} slots "
            f"(min {bias.min().item():.1f}): max_abs_err={err:.3e} (tol {FLASH_TOL}) kernel "
            f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), bias-free K1 {nobias_ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")
        check(err <= FLASH_TOL, f"K1 bias error {err} > {FLASH_TOL}")
        worst = max(worst, err)
        if main is None:
            # the library's call for the same function: SDPA with a float
            # mask [1, H, S, T] in the inputs' bf16 holding the causal -inf
            # and the bias, each row shifted by its diagonal key's bias (the
            # softmax does not move; unshifted, bf16 cannot hold ALiBi's
            # -3,443 to a slope's precision)
            causal = torch.full((s, s), float("-inf"), device="cuda").triu(1)
            mask = ((bias[:, None, :] - bias[:, :, None]) + causal)[None].to(torch.bfloat16)

            def sdpa():
                return _bhsd(F.scaled_dot_product_attention(_bhsd(q), _bhsd(k), _bhsd(v),
                                                            attn_mask=mask))

            lib_ms = time_ms(sdpa)
            lib_err = (sdpa().float() - want).abs().max().item()
            check(lib_err == lib_err, "SDPA with the mask gave NaN")
            nbytes = 2 * (2 * b * s * h * d + 2 * b * s * hkv * d) + 4 * h * s  # + the table
            main = kernel_row(None, ms, plain_ms, nbytes, flops, lib_ms)
            extra = {"k1_bias_ms": ms, "k1_no_bias_ms": nobias_ms, "sdpa_mask_ms": lib_ms,
                     "sdpa_mask_max_abs_err": lib_err}
            log(f"[K1 bias] same shape: scaled_dot_product_attention with a bf16 mask "
                f"[1, {h}, {s}, {s}] {lib_ms:.4f} ms (max_abs_err against the plain twin "
                f"{lib_err:.3e}); bound {main['bound_ms']:.4f} ms ({main['bound_by']})")
    main["max_abs_err"] = worst

    b, s, h, d = 1, 768, 32, 128
    q, k, v = _randn((b, s, h, d), gen), _randn((b, s, h, d), gen), _randn((b, s, h, d), gen)
    bias = _alibi_table(h, s)
    o, m, l = flash_mod._fwd_res_cuda(q, k, v, True, d ** -0.5, bias)
    sync()
    want_m, want_l = flash_mod.flash_statistics_plain(q.float(), k.float(), v.float(),
                                                      bias_k=bias)
    want = flash_mod.flash_attention_plain(q.float(), k.float(), v.float(), bias_k=bias)
    o_err = (o.float() - want).abs().max().item()
    m_err = (m - want_m).abs().max().item()
    l_err = ((l - want_l).abs() / want_l).max().item()
    log(f"[K4a bias] B={b} S={s} H={h} D={d}: o max_abs_err {o_err:.3e} (tol {FLASH_TOL}), "
        f"m {m_err:.3e} (tol {MPT_STAT_M_TOL}), l relative {l_err:.3e} (tol {STAT_L_REL_TOL})")
    check(o_err <= FLASH_TOL and m_err <= MPT_STAT_M_TOL and l_err <= STAT_L_REL_TOL,
          "K4a's bias branch against flash_statistics_plain")
    return main, extra


def mpt_teochat_config():
    """LLaVA-MPT at MPT-7B's published geometry (mosaicml/mpt-7b config.json:
    d_model 4096, 32 layers, 32 heads, expansion 4, ALiBi with bias max 8,
    no_bias, vocab 50,432) beside the full CLIP ViT-L/14 tower and the
    mlp2x_gelu projector to 4096."""
    base = TEOChatConfig()
    llm = MptConfig(vocab_size=50432)
    return dataclasses.replace(base, llm=llm, llm_backend="mpt",
                               projector=dataclasses.replace(base.projector,
                                                             hidden_size=llm.d_model))


def _greedy_or_near_tie(model, ids, frames, got, want, what):
    """A greedy path's tokens against another's: equal, or (two bf16 paths
    that reduce in other orders, at a near-tie) each of `got`'s tokens
    within SPEC_GAP_TOL rms of its position's largest logit in a
    teacher-forced prefill. Returns whether they were equal."""
    if got == want:
        log(f"[mpt] {what}: the same {len(got)} tokens")
        return True
    gaps, _ = teacher_forced_gaps(model, ids, frames, got)
    log(f"[mpt] {what}: the tokens leave the other path's at {_first_difference(got, want)}; "
        f"each token's teacher-forced gap: largest {max(gaps):.3e} (bound {SPEC_GAP_TOL})")
    check(max(gaps) <= SPEC_GAP_TOL, f"mpt {what}: a token {max(gaps)} rms below its max")
    return False


def phase_mpt(gen):
    """The MPT serving path at MPT-7B width and depth, int8 (random weights
    from `gen`): (b) a 2-frame greedy request of 32 tokens through
    TEOChat.generate, K1's bias branch launching once a layer for the
    prefill and no decode kernel after it, TTFT and decode tok/s, the
    prefill's last logits against plain attention; (c) the decode graph's
    tokens and last logits bit-equal to the eager loop's, twice; (d) a
    speculative greedy request (k 4) against the plain tokens; (e) a
    session's turn 2 and an engine request. Returns (the request's launch
    counts, the JSON entry, the model: phase 23 trains it)."""
    t_start = time.perf_counter()
    tokenizer = WordTokenizer()
    cfg = mpt_teochat_config()
    model = teochat_mod.TEOChat(cfg, init_teochat(cfg, gen, "cuda", torch.bfloat16,
                                                  quant="int8"), tokenizer=tokenizer)
    n_layers = cfg.llm.n_layers
    log(f"[mpt] LLaVA-MPT-7B int8 drawn in {time.perf_counter() - t_start:.1f} s: "
        f"{_tree_bytes(model.params['llm']) / 2**30:.3f} GiB decoder, "
        f"allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    processor = FrameProcessor(cfg.vision.image_size, SEED)
    frames = processor.preprocess(["a", "b"])["pixel_values"]
    ids = tokenizer_image_token(PROMPT_2.replace("<video>", "Image 1: <image> Image 2: <image>"),
                                tokenizer, IMAGE_TOKEN_INDEX)
    g1 = GenerationConfig(max_new_tokens=1, temperature=0.0, do_sample=False, stop_strings=())
    g32 = dataclasses.replace(g1, max_new_tokens=32)
    gen_mod.clear_decode_graphs()

    # (b) the request, its launches, TTFT and decode
    out, counts = counted("mpt", lambda: model.generate([ids], frames, g32))
    out = out[0]
    check(len(out) == 32 and all(0 <= t < cfg.llm.vocab_size for t in out), "mpt tokens")
    check(counts["K1 bias"] == n_layers, f"mpt: K1's bias branch launched {counts['K1 bias']} "
          f"times for the prefill, not {n_layers}")
    check(counts["K5"] > 0 and counts["K1"] == counts["K2"] == counts["K2m"] == 0,
          f"mpt: launches {counts}")
    ttfts, fulls = [], []
    for _ in range(3):
        ttfts.append(wall(lambda: model.generate([ids], frames, g1))[1])
        fulls.append(wall(lambda: model.generate([ids], frames, g32))[1])
    # the least of each term's runs: a stall lengthens a run and never
    # shortens one, so a median prefill could exceed the fastest full loop
    ttft_s, full_s = min(ttfts), min(fulls)
    tok_s = 31 / (full_s - ttft_s)
    log(f"[mpt] 2-frame bs1 ({len(ids)} ids): TTFT {ttft_s * 1e3:.2f} ms, decode 31 steps "
        f"{tok_s:.2f} tok/s ({(full_s - ttft_s) / 31 * 1e3:.2f} ms/step), from the least of 3 "
        f"interleaved generates of 1 and of 32 tokens; answer {tokenizer.decode(out[:12])!r}")
    rel = phase_logits(model, ids, frames)

    # (c) the decode graph against the eager loop
    runs = {}
    for graphed in (False, True, True):
        with decode_loop(graphed) as last:
            got = model.generate([ids], frames, g32)[0]
        runs.setdefault(graphed, []).append((got, last["logits"]))
    (eager, eager_logits), replays = runs[False][0], runs[True]
    bit_equal = all(got == eager and torch.equal(lg, eager_logits) for got, lg in replays)
    entries = gen_mod.decode_graphs()
    log(f"[mpt graph] graph tokens and last logits {'bit-equal to' if bit_equal else 'DIFFER from'}"
        f" the eager loop's, twice; {len(entries)} graph, "
        f"{sum(e.replays for e in entries)} replays")
    check(bit_equal, "mpt: the decode graph's tokens or logits differ from the eager loop's")

    # (d) speculative greedy against the plain tokens
    spec = model.generate([ids], frames, dataclasses.replace(g32, speculative_k=4))[0]
    spec_stats = dict(model.last_spec_stats)
    spec_equal = _greedy_or_near_tie(model, ids, frames, spec, eager,
                                     f"speculative k 4 ({spec_stats})")

    # (e) a session's turn 2 and an engine request
    g16 = dataclasses.replace(g1, max_new_tokens=16)
    session = ChatSession(model, max_len=2048)
    turn1 = session.generate(ids, frames, g16)
    convo = ids + turn1 + tokenizer("What changed between the two images?").input_ids[1:]
    turn2, turn2_s = wall(lambda: session.generate(convo, frames, g16))
    check(session.stats["reused_tokens"] == len(ids) + len(turn1) - 1,
          f"mpt session: {session.stats}")
    session_equal = _greedy_or_near_tie(model, convo, frames, turn2,
                                        model.generate([convo], frames, g16)[0],
                                        f"session turn 2 ({turn2_s * 1e3:.1f} ms, {session.stats})")
    del session
    engine = engine_mod.BatchEngine(model, max_slots=2, max_len=1024, chunk=8).start()
    try:
        engine_out, engine_s = wall(lambda: engine.submit(ids, frames, g16))
    finally:
        engine.shutdown()
    engine_equal = _greedy_or_near_tie(model, ids, frames, engine_out, eager[:16],
                                       f"engine request ({engine_s * 1e3:.1f} ms)")
    del engine
    gen_mod.clear_decode_graphs()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[mpt] phase {time.perf_counter() - t_start:.1f} s")
    return counts, {"ttft_ms": ttft_s * 1e3, "decode_tokens_per_sec": tok_s,
                    "prefill_logits_rel_l2": rel, "graph_bit_equal": bit_equal,
                    "spec_tokens_equal": spec_equal, "spec_stats": spec_stats,
                    "session_turn2_ms": turn2_s * 1e3, "session_tokens_equal": session_equal,
                    "engine_ms": engine_s * 1e3, "engine_tokens_equal": engine_equal}, model


# ------------------------------------------------- phase 23: MPT training

K4_BIAS_COUNTERS = {"fwd": flash_mod.FWD_RES_BIAS_LAUNCHES, "dkv": flash_mod.BWD_DKV_BIAS_LAUNCHES,
                    "dq": flash_mod.BWD_DQ_BIAS_LAUNCHES}


def _mpt_training_table(h, s):
    """MPT-7B's ALiBi table as mpt_forward sizes it without a cache: [H, S],
    each head's last key's bias 0."""
    return mpt_mod.alibi_bias(h, s, device="cuda")[0, :, 0, :]


def _time_flash_bias(q, k, v, do, bias):
    """K4a, K4b and K4c with `bias` alone at one shape, beside the bias-free
    kernels on the same inputs, the plain twin's forward and backward with
    the table, and scaled_dot_product_attention with phase 22's shifted bf16
    mask (forward; dq, dk and dv in one backward call); returns each
    kernel's row for the JSON line (its error filled in later) and the
    numbers."""
    b, s, h, d = q.shape
    scale = d ** -0.5
    o, m, l = flash_mod._fwd_res_cuda(q, k, v, True, scale, bias)
    di = flash_mod._bwd_di_cuda(o, do)
    o0, m0, l0 = flash_mod._fwd_res_cuda(q, k, v, True, scale)
    di0 = flash_mod._bwd_di_cuda(o0, do)
    t = {
        "fwd": time_ms(lambda: flash_mod._fwd_res_cuda(q, k, v, True, scale, bias)),
        "fwd_free": time_ms(lambda: flash_mod._fwd_res_cuda(q, k, v, True, scale)),
        "dkv": time_ms(lambda: flash_mod._bwd_dkv_cuda(q, k, v, do, m, l, di, True, scale, bias)),
        "dkv_free": time_ms(lambda: flash_mod._bwd_dkv_cuda(q, k, v, do, m0, l0, di0, True,
                                                            scale)),
        "dq": time_ms(lambda: flash_mod._bwd_dq_cuda(q, k, v, do, m, l, di, True, scale, bias)),
        "dq_free": time_ms(lambda: flash_mod._bwd_dq_cuda(q, k, v, do, m0, l0, di0, True,
                                                          scale)),
        "plain_fwd": time_ms(lambda: flash_mod.flash_attention_plain(q, k, v, bias_k=bias)),
    }
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    op = flash_mod.flash_attention_plain(qg, kg, vg, bias_k=bias)
    t["plain_bwd"] = time_ms(lambda: torch.autograd.grad(op, (qg, kg, vg), do, retain_graph=True))
    del op
    causal = torch.full((s, s), float("-inf"), device="cuda").triu(1)
    mask = ((bias[:, None, :] - bias[:, :, None]) + causal)[None].to(torch.bfloat16)
    qt, kt, vt = (_bhsd(x).detach().requires_grad_(True) for x in (q, k, v))
    t["lib_fwd"] = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    ol = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    t["lib_bwd"] = time_ms(
        lambda: torch.autograd.grad(ol, (qt, kt, vt), _bhsd(do), retain_graph=True))
    del ol, mask
    product = 2 * b * h * s * s * d / 2  # one causal S x S x D product
    tensor, stat, table = 2 * q.numel(), 4 * b * h * s, 4 * h * s
    log(f"[K4 bias] B={b} S={s} H={h} D={d} with MPT-7B's table: K4a {t['fwd']:.4f} ms "
        f"(bias-free {t['fwd_free']:.4f} ms, x{t['fwd'] / t['fwd_free']:.3f}; "
        f"{2 * product / t['fwd'] / 1e9:.1f} TFLOP/s), K4b {t['dkv']:.4f} ms (bias-free "
        f"{t['dkv_free']:.4f} ms, x{t['dkv'] / t['dkv_free']:.3f}; "
        f"{4 * product / t['dkv'] / 1e9:.1f} TFLOP/s), K4c {t['dq']:.4f} ms (bias-free "
        f"{t['dq_free']:.4f} ms, x{t['dq'] / t['dq_free']:.3f}; "
        f"{3 * product / t['dq'] / 1e9:.1f} TFLOP/s); plain forward {t['plain_fwd']:.4f} ms, "
        f"plain backward {t['plain_bwd']:.4f} ms; scaled_dot_product_attention with the bf16 "
        f"mask [1, {h}, {s}, {s}]: forward {t['lib_fwd']:.4f} ms, backward {t['lib_bwd']:.4f} ms; "
        f"{_timing.smi_line()}")
    # bytes: bf16 [B, S, H, D] tensors in and out, fp32 [B, H, S] statistics
    # and the fp32 [H, S] table; operations: the products each kernel's
    # function needs (K4a: S and PV; K4b: S, dP, dV, dK; K4c: S, dP, dQ)
    rows = {
        "fwd": kernel_row(None, t["fwd"], t["plain_fwd"], 4 * tensor + 2 * stat + table,
                          2 * product, t["lib_fwd"]),
        "dkv": kernel_row(None, t["dkv"], t["plain_bwd"], 6 * tensor + 3 * stat + table,
                          4 * product, t["lib_bwd"]),
        "dq": kernel_row(None, t["dq"], t["plain_bwd"], 5 * tensor + 3 * stat + table,
                         3 * product, t["lib_bwd"]),
    }
    return rows, {f"k4_bias_{key}_ms": value for key, value in t.items()}


def phase_mpt_train_kernels(gen):
    """(a) K4b's and K4c's bias branches against their tile walks and the
    trainable path with the table against plain autograd, at the training
    shape, multiquery at a ragged S and with a cache-sized table; timed at
    the training shape. Returns (the three rows, the numbers)."""
    cases = [  # (B, S, H, Hkv, D, the table's slots: None sizes it to S)
        (4, 1024, 32, 32, 128, None),  # the training shape of the K4 rows
        (1, 700, 32, 1, 128, None),  # multiquery: one kv head, a group of 32, ragged S
        (1, 768, 32, 32, 128, MPT_TABLE_SLOTS),  # each head's last bias far from 0
    ]
    worst = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
    rows = extra = None
    for b, s, h, hkv, d, slots in cases:
        q, k, v = _randn((b, s, h, d), gen), _randn((b, s, hkv, d), gen), _randn((b, s, hkv, d), gen)
        do = _randn((b, s, h, d), gen)
        bias = _mpt_training_table(h, s) if slots is None else _alibi_table(h, s)
        scale = d ** -0.5
        o, m, l = flash_mod._fwd_res_cuda(q, k, v, True, scale, bias)
        di = flash_mod._bwd_di_cuda(o, do)
        dk, dv = flash_mod._bwd_dkv_cuda(q, k, v, do, m, l, di, True, scale, bias)
        dq = flash_mod._bwd_dq_cuda(q, k, v, do, m, l, di, True, scale, bias)
        sync()
        want_dk, want_dv = flash_mod.flash_backward_dkv_schedule(q, k, v, do, m, l, di,
                                                                 bias_k=bias)
        want_dq = flash_mod.flash_backward_dq_schedule(q, k, v, do, m, l, di, bias_k=bias)
        walks = [_check_grad(name, g.float(), w.float(), WALK_REL_L2, WALK_REL_MAX)
                 for name, g, w in (("dq", dq, want_dq), ("dk", dk, want_dk), ("dv", dv, want_dv))]
        got = _flash_grads(lambda q, k, v: flash_mod.flash_attention_trainable_padded(
            q, k, v, True, bias_k=bias), q, k, v, do)
        sync()
        want = _flash_grads(lambda q, k, v: flash_mod.flash_attention_plain(
            q.float(), k.float(), v.float(), bias_k=bias), q, k, v, do)
        errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
        check(all(torch.isfinite(g).all().item() for g in got), "flash backward with bias finite")
        check(errs[0] <= FLASH_TOL, f"K4a bias output error {errs[0]} > {FLASH_TOL}")
        rel = [_check_grad(name, g, w, GRAD_REL_L2, GRAD_REL_MAX)
               for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:])]
        worst["fwd"] = max(worst["fwd"], errs[0])
        worst["dq"] = max(worst["dq"], errs[1])
        worst["dkv"] = max(worst["dkv"], errs[2], errs[3])
        del got, want
        log(f"[K4 bias] B={b} S={s} H={h} Hkv={hkv} D={d} table "
            f"{'sized to S' if slots is None else f'of {slots} slots'} (min "
            f"{bias.min().item():.1f}, last key {bias[0, -1].item():.1f}): vs the tile walks: "
            + "; ".join(walks) + "; trainable vs plain autograd: o max_abs_err "
            f"{errs[0]:.3e}, " + "; ".join(rel))
        if rows is None:
            rows, extra = _time_flash_bias(q, k, v, do, bias)
        elif hkv == 1:
            extra["k4_bias_multiquery_dkv_ms"] = time_ms(
                lambda: flash_mod._bwd_dkv_cuda(q, k, v, do, m, l, di, True, scale, bias))
            extra["k4_bias_multiquery_dq_ms"] = time_ms(
                lambda: flash_mod._bwd_dq_cuda(q, k, v, do, m, l, di, True, scale, bias))
            items = ((s + 127) // 128 + 1) // 2 * hkv * b
            log(f"[K4 bias] multiquery B={b} S={s} H={h} Hkv=1: K4b "
                f"{extra['k4_bias_multiquery_dkv_ms']:.4f} ms ({items} work items: {items} "
                f"blocks), K4c {extra['k4_bias_multiquery_dq_ms']:.4f} ms")
    for name, row in rows.items():
        row["max_abs_err"] = worst[name]
    gc.collect()
    torch.cuda.empty_cache()
    return rows, extra


def phase_mpt_train(model, gen):
    """(b) 3 optimizer steps of `train.train.train` on the phase-22 model
    (LoRA r128 / alpha 256 over the int8 backbone, batch 2, remat) and (c)
    one micro-step, kernels against plain attention. Returns (the K4 bias
    launches of (b), the JSON entry)."""
    from teochat_torch.train import train as train_mod

    t0 = time.perf_counter()
    cfg, params = model.cfg, model.params
    tokenizer = WordTokenizer()
    processor = FrameProcessor(cfg.vision.image_size, SEED)
    n_layers, steps, batch = cfg.llm.n_layers, 3, 2
    # the int8 kernels, to hold them bitwise after the run
    frozen = {path: x.clone() for path, x in tree_leaves_with_path(params["llm"])
              if x.dtype == torch.int8}
    os.makedirs("results", exist_ok=True)
    out = tempfile.mkdtemp(prefix="chip_smoke_mpt_train_", dir="results")
    history = []
    for counter in (*K4_BIAS_COUNTERS.values(), flash_mod.FWD_RES_LAUNCHES,
                    flash_mod.BWD_DKV_LAUNCHES, flash_mod.BWD_DQ_LAUNCHES):
        counter.reset()
    gc.collect()
    before_alloc = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        state, sec = wall(lambda: train_mod.train(
            train_mod.ModelArguments(mm_use_im_patch_token=False, mm_use_im_start_end=False),
            DataArguments(image_processor=processor),
            train_mod.TrainingArguments(
                output_dir=out, per_device_train_batch_size=batch, gradient_accumulation_steps=1,
                lora_enable=True, lora_r=128, lora_alpha=256, bits=8, bf16=True,
                gradient_checkpointing=True, learning_rate=2e-4, mm_projector_lr=2e-5,
                warmup_ratio=0.0, save_strategy="no", report_to="none", logging_steps=1,
                seed=SEED),
            cfg=cfg, params=params, tokenizer=tokenizer, dataset=train_samples(2 * steps * batch),
            max_steps_override=steps, history=history))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    launches = {name: c.count for name, c in K4_BIAS_COUNTERS.items()}
    free = _k4_counts()
    peak = (torch.cuda.max_memory_allocated() - before_alloc) / 2**30
    check(len(history) == steps and state.step == steps, "three optimizer steps")
    check(all(np.isfinite(h["loss"]) and h["loss"] > 0 for h in history),
          "MPT training losses finite and positive")
    _log_history("mpt train", history, 1)
    steady = history[1:]
    s_step = sum(h["seconds"] for h in steady) / len(steady)
    tok_s = sum(h["tokens"] for h in steady) / sum(h["seconds"] for h in steady)
    seq = history[0]["padded_tokens"] // batch
    per_micro = {name: n / steps for name, n in launches.items()}
    log(f"[mpt train] train.train.train (LLaVA-MPT-7B int8 + LoRA r128, batch {batch} x {seq} "
        f"fused tokens, remat): {sec:.2f} s for {steps} steps (with the set-up and the final "
        f"save); steps 2-3: {s_step:.3f} s/step, {tok_s:.1f} valid tokens/s; peak allocated "
        f"{peak:.3f} GiB above the {before_alloc / 2**30:.3f} GiB held before; "
        f"{_timing.smi_line()}")
    log(f"[mpt train] launches over {steps} micro-steps of {n_layers} layers: with the bias "
        f"K4a {launches['fwd']}, K4b {launches['dkv']}, K4c {launches['dq']} (a micro-step: "
        f"{per_micro}); bias-free {free}")
    check(per_micro == {"fwd": 2 * n_layers, "dkv": n_layers, "dq": n_layers},
          f"K4 bias launches a micro-step {per_micro}")
    check(not any(free.values()), f"bias-free K4 launches during MPT training: {free}")
    dev = gen_mod.embedding_table(params["llm"]).device
    init_lora = add_lora_params(torch.Generator(device=dev).manual_seed(SEED), params["llm"],
                                rank=128, alpha=256.0)
    want = dict(tree_leaves_with_path(partition_params({"llm": init_lora},
                                                       lora_trainable_filter)[0]))
    got = dict(tree_leaves_with_path(partition_params({"llm": state.params["llm"]},
                                                      lora_trainable_filter)[0]))
    check(sorted(got) == sorted(want) and len(got) == 2 * len(MPT_TARGET_NAMES),
          f"MPT LoRA leaves {sorted(got)}")
    for path, x in got.items():
        check(not torch.equal(x, want[path]), f"{path} did not change")
    before_proj = dict(tree_leaves_with_path(params["projector"]))
    for path, x in tree_leaves_with_path(state.params["projector"]):
        check(not torch.equal(x, before_proj[path].float()), f"projector/{path} did not change")
    after = dict(tree_leaves_with_path(state.params["llm"]))
    for path, x in frozen.items():
        check(torch.equal(after[path], x), f"the int8 kernel {path} changed")
    del init_lora, want, got, state, frozen, after
    gc.collect()
    torch.cuda.empty_cache()
    train_s = time.perf_counter() - t0

    # (c)
    parity = phase_train_parity(cfg, params, tokenizer, processor, gen, rows=batch,
                                tag="mpt train parity")
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {"step_s": s_step, "tokens_per_s": tok_s, "peak_gib": peak,
                      "seq": seq, "losses": [h["loss"] for h in history],
                      "launches_per_micro_step": per_micro, "train_s": train_s,
                      "parity": parity, "phase_s": time.perf_counter() - t0}


# ------------------------------------------------------------------ phase 24: the mesh

P24_LAYERS = 4  # LLaMA-7B's width, depth cut from 32 (phase 24's time budget)
P24_SEQ = 1024  # a row's fused length: one frame's 256 tokens and 768 of text
P24_ROWS = 2
P24_MESHES = ((1, 2, 1), (1, 1, 2))
P24_LOSS_REL = 1e-2  # PERF.md section 4's micro-step bounds: the loss,
P24_GRAD_REL = 1.5e-1  # each gradient of the first step,
P24_LEAF_REL = 1.5e-1  # and each trained leaf after the steps
P24_OPT = dict(learning_rate=2e-4, projector_lr=2e-5, lr_scheduler_type="constant",
               max_grad_norm=1.0, total_steps=10)
TOWER_TRAIN_GRAD_REL = 1.5e-1  # bf16 on the card against fp32 on the CPU
# a tiny tower the flash kernels take: head_dim 64, S 17
TOWER_TINY = VisionConfig(image_size=56, patch_size=14, hidden_size=128, intermediate_size=256,
                          num_layers=2, num_heads=2)


def p24_config():
    cfg = TEOChatConfig()
    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, num_layers=P24_LAYERS))


def p24_batches(cfg, n, rows_n=P24_ROWS, seq=P24_SEQ):
    """n global batches of `rows_n` rows of `seq` fused tokens (one frame a
    row, labels on the text's second half), the same on every process."""
    out = []
    text = seq - cfg.vision.num_patches + 1
    for i in range(n):
        rs = np.random.RandomState(SEED + 24 + i)
        rows = []
        for _ in range(rows_n):
            ids = [1] + rs.randint(3, cfg.llm.vocab_size, text - 1).tolist()
            ids[1] = IMAGE_TOKEN_INDEX
            rows.append({"ids": ids, "labels": [-100] * (text // 2) + ids[text // 2:],
                         "frames": rs.randn(1, 3, 224, 224).astype(np.float32)})
        out.append(rows)
    return out


def p24_params(cfg, device):
    """The recipe's trainable set at seed 0: random int8 LLaMA, LoRA r128
    (B drawn nonzero), fp32 masters; built alike on every process."""
    from teochat_torch.train.trainer import fp32_masters as masters

    gen = torch.Generator(device=device).manual_seed(SEED)
    params = init_teochat(cfg, gen, device, torch.bfloat16, quant="int8")
    llm = add_lora_params(gen, params["llm"], rank=128, alpha=256.0)
    for proj in _lora_projections(llm):
        proj["lora_b"] = torch.randn(proj["lora_b"].shape, generator=gen, device=device) * 1e-3
    return masters({**params, "llm": llm}, lora_trainable_filter)


def p24_plan(cfg, rows, device):
    plan = fusion_mod.build_fusion_plan(
        [r["ids"] for r in rows], labels=[r["labels"] for r in rows],
        tokens_per_frame=cfg.vision.num_patches)
    pixels = torch.from_numpy(np.concatenate([r["frames"] for r in rows]))
    return plan, pixels.to(device, torch.bfloat16)


def p24_steps(cfg, state, batches, device, sharded=None, on_step=None, grads=None):
    """Optimizer steps over `batches` (a rank's rows of each on a mesh);
    (state, losses, seconds a step). `grads`, a dict, gets the first
    step's gradients as the optimizer takes them (on a mesh: this rank's
    shards, summed over the row ranks)."""
    from teochat_torch.train import trainer as trainer_mod

    optimizer = trainer_mod.make_optimizer(**P24_OPT)
    if grads is not None:
        inner = optimizer.step

        def keep_first(params, g, state, sq_norm=None):
            if not grads:
                grads.update({p: x.detach().clone() for p, x in g.items()})
            return inner(params, g, state, sq_norm)

        optimizer.step = keep_first
    step = trainer_mod.make_train_step(cfg, optimizer, trainable_filter=lora_trainable_filter,
                                       remat=True, sharded=sharded)
    losses, secs = [], []
    for rows in batches:
        if sharded is not None:
            k = len(rows) // sharded.row_count
            rows = rows[sharded.row_rank * k:(sharded.row_rank + 1) * k]
        plan, pixels = p24_plan(cfg, rows, device)
        sync()
        t = time.perf_counter()
        state, loss = step(state, plan, pixels)
        sync()
        secs.append(time.perf_counter() - t)
        losses.append(loss.item())
        if on_step is not None:
            on_step(state, len(losses))
    return state, losses, secs


def _trained_leaves(params):
    return {p: x.detach().float().cpu() for p, x in tree_leaves_with_path(params)
            if lora_trainable_filter(p)}


class _CommTimer:
    """Seconds the card waits on the mesh's collectives and point-to-point
    traffic (each call bracketed by synchronizes), by wrapping
    parallel/tensor_parallel.py's helpers."""

    NAMES = (("gather", "_all_gather"), ("scatter", "_reduce_scatter"), ("reduce", "_all_reduce"),
             ("p2p", "exchange"), ("broadcast", "_broadcast"))

    def __init__(self):
        from teochat_torch.parallel import tensor_parallel as tp

        self.tp, self.seconds, self.saved = tp, {key: 0.0 for key, _ in self.NAMES}, {}

    def __enter__(self):
        for key, name in self.NAMES:
            fn = getattr(self.tp, name)
            self.saved[name] = fn

            def timed(*a, _fn=fn, _key=key):
                sync()
                t = time.perf_counter()
                out = _fn(*a)
                sync()
                self.seconds[_key] += time.perf_counter() - t
                return out

            setattr(self.tp, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.tp, name, fn)
        return False


def rank_main(out_dir):
    """One of phase 24's two ranks on the one card (`chip_smoke.py --ranks DIR`)."""
    import torch.distributed as dist

    from teochat_torch.checkpoint import orbax_io
    from teochat_torch.checkpoint.orbax_io import _as_dtensor
    from teochat_torch.config import MeshConfig
    from teochat_torch.parallel import Sharded, create_mesh, init_distributed, shard_params
    from teochat_torch.parallel.sharding import unshard
    from teochat_torch.train import trainer as trainer_mod
    from teochat_torch.train.train import _prune_checkpoints

    import faulthandler

    faulthandler.enable()  # a rank that dies prints where
    rank = int(os.environ["RANK"])
    device = init_distributed("cuda", backend="gloo", device=torch.device("cuda", 0),
                              init_method=f"file://{os.path.join(out_dir, 'init')}",
                              rank=rank, world_size=2)
    log(f"[mesh rank {rank}] joined: {dist.get_backend()}, {dist.get_world_size()} ranks")
    summary = {"backend": dist.get_backend(), "world": dist.get_world_size(), "collectives": {}}
    x = torch.full((4,), float(rank + 1), device=device)
    for name, fn in (
            ("all_gather", lambda: dist.all_gather_into_tensor(torch.empty(8, device=device), x)),
            ("reduce_scatter", lambda: dist.reduce_scatter_tensor(
                torch.empty(2, device=device), x)),
            ("all_reduce", lambda: dist.all_reduce(x.clone())),
            ("broadcast", lambda: dist.broadcast(x.clone(), 0))):
        fn()
        sync()
        summary["collectives"][name] = "ok"
    log(f"[mesh rank {rank}] collectives ran: {summary['collectives']}")
    cfg = p24_config()
    batches = p24_batches(cfg, 2)
    for shape in P24_MESHES:
        tag = "".join(map(str, shape))
        mesh = create_mesh(MeshConfig(*shape), "cuda")
        torch.cuda.reset_peak_memory_stats()
        params = shard_params(p24_params(cfg, device), mesh, cfg)
        sharded = Sharded(mesh, cfg, params)
        log(f"[mesh rank {rank}] mesh {shape}: params placed")
        state = trainer_mod.init_train_state(params, trainer_mod.make_optimizer(**P24_OPT),
                                             lora_trainable_filter)
        entry = {}
        ckpt = os.path.join(out_dir, "ckpt")

        def save(st, n, entry=entry):
            if shape != P24_MESHES[0]:
                return
            dist.barrier()
            t = time.perf_counter()
            orbax_io.save_checkpoint(ckpt, st.params, cfg, opt_state=st.opt_state, step=n)
            entry[f"save_{n}_s"] = time.perf_counter() - t
            if rank == 0:
                _prune_checkpoints(ckpt, 1)
            dist.barrier()

        k4, k5 = _k4_counts(), vit_mod.LAUNCHES.count
        grads = {}
        with _CommTimer() as comm:
            state, losses, secs = p24_steps(cfg, state, batches, device, sharded, on_step=save,
                                            grads=grads)
        counts = {**{k: v - k4[k] for k, v in _k4_counts().items()},
                  "K5": vit_mod.LAUNCHES.count - k5}
        both = torch.tensor(list(counts.values()), dtype=torch.int64)
        dist.all_reduce(both)  # the two ranks' launches together
        entry.update(losses=losses, step_s=secs, comm_s=comm.seconds,
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                     launches=dict(zip(counts, both.tolist())))
        log(f"[mesh rank {rank}] mesh {shape}: losses {losses}, s a step {secs}")
        like = dict(tree_leaves_with_path(state.params))
        leaves = {p: unshard(x, p, cfg).float().cpu() for p, x in like.items()
                  if lora_trainable_filter(p)}
        grads = {p: unshard(_as_dtensor(g, like[p]), p, cfg).float().cpu()
                 for p, g in grads.items()}
        if rank == 0:
            torch.save({"entry": entry, "leaves": leaves, "grads": grads},
                       os.path.join(out_dir, f"mesh_{tag}.pt"))
        del state, params, sharded, leaves, grads, like
        gc.collect()
        torch.cuda.empty_cache()
    if rank == 0:
        with open(os.path.join(out_dir, "ranks.json"), "w") as f:
            json.dump(summary, f)
    dist.destroy_process_group()


def run_ranks(flag, out_dir, what, timeout=600):
    """This script's two ranks (`chip_smoke.py FLAG OUT_DIR`, RANK and
    WORLD_SIZE in their environment) on the one card; their seconds. Fails
    unless both exit 0; a rank still running at `timeout` is killed."""
    import subprocess

    env = {**os.environ, "WORLD_SIZE": "2"}
    t = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, out_dir],
                              env={**env, "RANK": str(r)}) for r in range(2)]
    try:
        codes = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(codes == [0, 0], f"{what} ranks exited {codes}")
    return time.perf_counter() - t


def _rel(got, want):
    return ((got - want).norm() / want.norm().clamp(min=1e-30)).item()


def _rel_l2(got, want, before):
    d = (got - before) - (want - before)
    return (d.norm() / (want - before).norm().clamp(min=1e-30)).item()


def phase_mesh(gen):
    """Phase 24 (a)-(c): two ranks on the one card (gloo over CUDA tensors:
    NCCL refuses two ranks on one device, `chip_probe.py two-ranks`), the
    recipe's shape on meshes (1, 2, 1) and (1, 1, 2) against one rank,
    a sharded save, prune, a one-process load and a resume."""
    from teochat_torch.checkpoint import orbax_io
    from teochat_torch.train import trainer as trainer_mod

    t0 = time.perf_counter()
    cfg, device = p24_config(), torch.device("cuda")
    batches = p24_batches(cfg, 3)
    k4, k5 = _k4_counts(), vit_mod.LAUNCHES.count
    # the one-rank reference: 3 steps, the trainable leaves after 2
    params = p24_params(cfg, device)
    before = _trained_leaves(params)
    state = trainer_mod.init_train_state(params, trainer_mod.make_optimizer(**P24_OPT),
                                         lora_trainable_filter)
    torch.cuda.reset_peak_memory_stats()
    kept, ref_grads = {}, {}
    state, ref_losses, ref_secs = p24_steps(
        cfg, state, batches, device, grads=ref_grads,
        on_step=lambda st, n: kept.update(leaves=_trained_leaves(st.params)) if n == 2 else None)
    ref_grads = {p: g.float().cpu() for p, g in ref_grads.items()}
    ref_peak = torch.cuda.max_memory_allocated() / 2**30
    del state, params
    gc.collect()
    torch.cuda.empty_cache()

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_", dir="results")
    try:
        ranks_s = run_ranks("--ranks", out_dir, "phase 24")
        with open(os.path.join(out_dir, "ranks.json")) as f:
            summary = json.load(f)
        log(f"[mesh] backend {summary['backend']} over CUDA tensors, {summary['world']} ranks on "
            f"cuda:0: NCCL refuses two ranks on one device ('Duplicate GPU detected', "
            f"chip_probe.py two-ranks); gloo ran {summary['collectives']}")
        entries = {}
        for shape in P24_MESHES:
            tag = "".join(map(str, shape))
            got = torch.load(os.path.join(out_dir, f"mesh_{tag}.pt"), weights_only=False)
            e = got["entry"]
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(e["losses"], ref_losses[:2]))
            grad_rels = {p: _rel(got["grads"][p], ref_grads[p]) for p in ref_grads}
            leaf_rels = {p: _rel(got["leaves"][p], kept["leaves"][p]) for p in before}
            change_rels = {p: _rel_l2(got["leaves"][p], kept["leaves"][p], before[p])
                           for p in before}
            wg, wl, wc = (max(r, key=r.get) for r in (grad_rels, leaf_rels, change_rels))
            comm = sum(e["comm_s"].values())
            log(f"[mesh] (data, fsdp, model) {shape}, {P24_LAYERS} of 32 layers at 7B width, "
                f"batch {P24_ROWS} x {P24_SEQ}, LoRA r128 over int8, remat: losses "
                f"{[round(x, 6) for x in e['losses']]} vs one rank's "
                f"{[round(x, 6) for x in ref_losses[:2]]} (max rel {loss_rel:.3e}, bound "
                f"{P24_LOSS_REL}); {len(grad_rels)} trained leaves: first step's gradients "
                f"worst {wg} rel L2 {grad_rels[wg]:.3e} (bound {P24_GRAD_REL}), leaves after 2 "
                f"steps worst {wl} {leaf_rels[wl]:.3e} (bound {P24_LEAF_REL}), their changes "
                f"worst {wc} {change_rels[wc]:.3e} (Adam's first steps move an element by "
                f"about lr whatever its gradient, so a gradient in bf16's noise moves either "
                f"way); s a step {e['step_s']} (one rank: {ref_secs[:2]}); collectives "
                f"{comm:.3f} s of {sum(e['step_s']):.3f} ({e['comm_s']}); peak "
                f"{e['peak_gib']:.2f} GiB a rank (one rank {ref_peak:.2f})")
            check(loss_rel <= P24_LOSS_REL, f"mesh {shape} loss rel {loss_rel}")
            check(grad_rels[wg] <= P24_GRAD_REL, f"mesh {shape} gradient {wg} {grad_rels[wg]}")
            check(leaf_rels[wl] <= P24_LEAF_REL, f"mesh {shape} leaf {wl} rel {leaf_rels[wl]}")
            entries[tag] = {**e, "loss_rel": loss_rel, "worst_grad": wg,
                            "worst_grad_rel_l2": grad_rels[wg], "worst_leaf": wl,
                            "worst_leaf_rel_l2": leaf_rels[wl], "worst_change": wc,
                            "worst_change_rel_l2": change_rels[wc],
                            "comm_share": comm / sum(e["step_s"])}
        # (c) the sharded checkpoint of mesh (1, 2, 1) on one process, bitwise
        ckpt_root = os.path.join(out_dir, "ckpt")
        check(sorted(os.listdir(ckpt_root)) == ["checkpoint-2"], f"pruned to {os.listdir(ckpt_root)}")
        ckpt = os.path.join(ckpt_root, "checkpoint-2")
        ckpt_gb = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(ckpt)
                      for f in fs) / 1e9
        sharded_leaves = torch.load(os.path.join(out_dir, "mesh_121.pt"),
                                    weights_only=False)["leaves"]
        params = p24_params(cfg, device)
        template = trainer_mod.init_train_state(params, trainer_mod.make_optimizer(**P24_OPT),
                                                lora_trainable_filter)
        sync()
        t = time.perf_counter()
        loaded, _, opt = orbax_io.load_checkpoint(ckpt, restore_opt=True,
                                                  params_template=template.params,
                                                  opt_template=template.opt_state)
        sync()
        load_s = time.perf_counter() - t
        flat = dict(tree_leaves_with_path(loaded))
        for path, x in sharded_leaves.items():
            check(torch.equal(flat[path].float().cpu(), x), f"loaded {path} != the gathered shards")
        for path, x in tree_leaves_with_path(params):
            if not lora_trainable_filter(path):
                check(torch.equal(flat[path], x), f"loaded frozen {path} changed")
        state, losses, _ = p24_steps(cfg, trainer_mod.TrainState(loaded, opt, 2), batches[2:],
                                     device)
        resume_rel = abs(losses[0] - ref_losses[2]) / abs(ref_losses[2])
        log(f"[mesh] checkpoint of (1, 2, 1): saved at steps 1 and 2 by both ranks "
            f"({entries['121']['save_1_s']:.2f} s, {entries['121']['save_2_s']:.2f} s), "
            f"pruned to checkpoint-2, {ckpt_gb:.3f} GB; loaded on one process in {load_s:.2f} s, "
            f"{len(sharded_leaves)} trained leaves bitwise the gathered shards, the frozen ones "
            f"bitwise the seed's; resumed step 3 loss {losses[0]:.6f} vs one rank's "
            f"{ref_losses[2]:.6f} (rel {resume_rel:.3e})")
        check(resume_rel <= P24_LOSS_REL, f"resume loss rel {resume_rel}")
        del state, params, loaded, opt, template
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    # launches: this process's (the one-rank reference and the resume) and
    # both ranks' (each mesh's steps)
    launches = {k: v - k4[k] for k, v in _k4_counts().items()}
    launches["K5"] = vit_mod.LAUNCHES.count - k5
    for e in entries.values():
        for k in launches:
            launches[k] += e["launches"][k]
    return launches, {"backend": summary["backend"], "world": summary["world"],
            "layers": P24_LAYERS,
            "reference": {"losses": ref_losses, "step_s": ref_secs, "peak_gib": ref_peak},
            "meshes": entries, "checkpoint_gb": ckpt_gb, "load_s": load_s,
            "resume_loss_rel": resume_rel, "ranks_s": ranks_s,
            "phase_s": time.perf_counter() - t0}


def _tiny_tower_grads(device, dtype, params, pixels, w):
    from teochat_torch.models.vit import vit_forward

    leaves = {p: x.detach().to(device, dtype).requires_grad_(True)
              for p, x in tree_leaves_with_path(params)}
    tree = {}
    for p, x in leaves.items():
        node = tree
        *head, last = p.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = x
    vcfg = TOWER_TINY
    out = vit_forward(tree, vcfg, pixels.to(device, dtype), select_layer=-1)
    loss = (out.float() * w.to(device)).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {p: g.float().cpu() for p, g in zip(leaves, grads) if g is not None}  # not post-LN


def phase_tower_train(gen):
    """Phase 24 (d): the tower trained on the card. TinyLlama-1.1B's
    geometry (bench/main.py) with the full ViT-L/14 tower, bf16 full
    fine-tuning, 2 steps of train(): the tower's attention takes K4a-c
    non-causally (K5 has no backward), every tower leaf the loss reaches
    moves; then a tiny tower's gradients on the card against the CPU's."""
    from teochat_torch.config import LlamaConfig
    from teochat_torch.train import train as train_mod

    t0 = time.perf_counter()
    cfg = TEOChatConfig(llm=LlamaConfig(hidden_size=2048, intermediate_size=5632, num_layers=22,
                                        num_heads=32, num_kv_heads=4))
    cfg = dataclasses.replace(cfg, projector=dataclasses.replace(cfg.projector, hidden_size=2048))
    params = init_teochat(cfg, torch.Generator(device="cuda").manual_seed(SEED + 24), "cuda",
                          torch.bfloat16, quant=None)
    before = {p: x.clone() for p, x in tree_leaves_with_path(params["vision"])}
    tokenizer = WordTokenizer()
    processor = FrameProcessor(cfg.vision.image_size, SEED)
    k4 = _k4_counts()
    k5 = vit_mod.LAUNCHES.count
    torch.cuda.reset_peak_memory_stats()
    out = tempfile.mkdtemp(prefix="chip_smoke_tower_", dir="results")
    history = []
    try:
        state = train_mod.train(
            train_mod.ModelArguments(freeze_backbone=False, mm_use_im_patch_token=False),
            DataArguments(image_processor=processor),
            train_mod.TrainingArguments(
                output_dir=out, lora_enable=False, per_device_train_batch_size=2,
                learning_rate=1e-5, mm_projector_lr=None, warmup_steps=0,
                lr_scheduler_type="constant", bf16=True, save_strategy="no",
                report_to="none", logging_steps=1, seed=SEED),
            cfg=cfg, params=params, tokenizer=tokenizer, dataset=train_samples(4),
            max_steps_override=2, history=history)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: v - k4[k] for k, v in _k4_counts().items()}
    k5_launches = vit_mod.LAUNCHES.count - k5
    n_vit = cfg.vision.num_layers - 1  # select_layer -2
    n_llm = cfg.llm.num_layers
    want = {"fwd": 2 * (n_vit + 2 * n_llm), "dkv": 2 * (n_vit + n_llm),
            "dq": 2 * (n_vit + n_llm)}
    moved = still = 0
    for path, x in tree_leaves_with_path(state.params["vision"]):
        if path.startswith("post_layernorm") or path == "layers/attn/k/bias":
            continue  # not reached by the loss; a key bias's exact gradient is 0
        changed = not torch.equal(x.float(), before[path].float())
        moved, still = moved + changed, still + (not changed)
        check(changed, f"tower leaf {path} did not move")
    losses = [h["loss"] for h in history]
    log(f"[tower train] TinyLlama-1.1B geometry ({n_llm} layers, h 2048, kv 4) with ViT-L/14, "
        f"bf16 full fine-tuning, 2 steps of train(): losses {losses}, s a step "
        f"{[round(h['seconds'], 3) for h in history]}, peak {peak:.2f} GiB; launches K4a "
        f"{launches['fwd']}, K4b {launches['dkv']}, K4c {launches['dq']} (expected {want}: "
        f"{n_vit} tower layers non-causal a step, the decoder's causal ones with remat), K5 "
        f"{k5_launches}; {moved} tower leaves moved")
    check(launches == want, f"K4 launches {launches} != {want}")
    check(k5_launches == 0, f"K5 launched {k5_launches} times in a training tower")
    check(all(np.isfinite(losses)), f"tower train losses {losses}")
    del state, params, before
    gc.collect()
    torch.cuda.empty_cache()

    # a tiny tower (head_dim 64, S 17) on the card in bf16 against the CPU in fp32
    from teochat_torch.checkpoint.bridge import init_encoder as encoder

    small = dataclasses.replace(TEOChatConfig(), vision=TOWER_TINY)
    vparams = encoder(small, torch.Generator(device="cuda").manual_seed(SEED + 25), "cuda",
                      torch.bfloat16)["vision"]
    vparams = {p: x.float().cpu() for p, x in tree_leaves_with_path(vparams)}
    rs = np.random.RandomState(SEED + 25)
    pixels = torch.from_numpy(rs.randn(2, 3, 56, 56).astype(np.float32)).bfloat16().float()
    w = torch.from_numpy(rs.randn(2, 17, 128).astype(np.float32))
    k4 = _k4_counts()
    card = _tiny_tower_grads("cuda", torch.bfloat16, vparams, pixels, w)
    tiny_launches = {k: v - k4[k] for k, v in _k4_counts().items()}
    cpu = _tiny_tower_grads("cpu", torch.float32, vparams, pixels, w)
    rels = {p: ((card[p] - cpu[p]).norm() / cpu[p].norm().clamp(min=1e-30)).item()
            for p in cpu if cpu[p].norm() > 0 and not p.endswith("attn/k/bias")}
    worst = max(rels, key=rels.get)
    log(f"[tower train] tiny tower (h 128, 2 heads of 64, 2 layers, S 17): gradients of "
        f"{len(rels)} leaves on the card (bf16, K4a-c launches {tiny_launches}) against the "
        f"CPU's (fp32): worst {worst} rel L2 {rels[worst]:.3e} (bound {TOWER_TRAIN_GRAD_REL})")
    check(rels[worst] <= TOWER_TRAIN_GRAD_REL, f"tiny tower gradient {worst} {rels[worst]}")
    check(tiny_launches["fwd"] == 2 and tiny_launches["dq"] == 2, f"{tiny_launches}")
    return launches, {"losses": losses, "step_s": [h["seconds"] for h in history],
                      "peak_gib": peak, "launches": launches, "k5_launches": k5_launches,
                      "tiny_worst_leaf_rel_l2": rels[worst],
                      "phase_s": time.perf_counter() - t0}


# phase 25: the ring and the pipeline on two ranks of the one card
P25_RING = (2, 4096, 32, 128)  # B, S, H, D: LLaMA-7B's attention, S split 2 x 2,048
P25_SEQ_ROWS, P25_SEQ = 2, 2048  # (c): mesh (1, 1, 1, sequence 2)
P25_PIPE_ROWS, P25_PIPE_SEQ = 4, 1024  # (d): mesh (1, 1, 1, 1, pipe 2)
P25_MICROBATCHES = (2, 4)
P25_MPT_LAYERS = 2  # (e): LLaVA-MPT-7B's width, 2 of 32 layers, one a stage
P25_MPT_ROWS = 2
P25_STEPS = 2
# the runs the ranks make: (tag, mesh (data, fsdp, model, sequence, pipe),
# microbatches, steps)
P25_RUNS = (("seq", (1, 1, 1, 2, 1), None, P25_STEPS),
            ("pipe_m2", (1, 1, 1, 1, 2), 2, P25_STEPS),
            ("pipe_m4", (1, 1, 1, 1, 2), 4, P25_STEPS),
            ("mpt", (1, 1, 1, 1, 2), 2, 1))


def p25_config(tag):
    if tag == "mpt":
        cfg = mpt_teochat_config()
        return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, n_layers=P25_MPT_LAYERS))
    return p24_config()


def p25_batches(cfg, tag, n):
    if tag == "seq":
        return p24_batches(cfg, n, P25_SEQ_ROWS, P25_SEQ)
    if tag == "mpt":
        return p24_batches(cfg, n, P25_MPT_ROWS, P25_PIPE_SEQ)
    return p24_batches(cfg, n, P25_PIPE_ROWS, P25_PIPE_SEQ)


def _k4_all():
    return {**_k4_counts(), **{f"{k}_bias": c.count for k, c in K4_BIAS_COUNTERS.items()}}


def _ring_alone(rank, group, n=2):
    """(b): the ring at LLaMA-7B's attention shape on the two ranks, on
    K4a-c and through the plain twin (fp32) on the same bf16 inputs: this
    rank's errors, launches, times and host-staged bytes."""
    from teochat_torch.parallel import ring_attention as ring_mod
    from teochat_torch.parallel import tensor_parallel as tp

    import torch.distributed as dist

    b, s, h, d = P25_RING
    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    full = [_randn((b, s, h, d), gen) for _ in range(4)]  # q, k, v, dO: the same on both ranks
    own = [x.chunk(n, 1)[rank].contiguous() for x in full]

    def run(impl, dtype=torch.bfloat16, rows=slice(None), heads=slice(None)):
        q, k, v = (x[rows, :, heads].detach().to(dtype).requires_grad_() for x in own[:3])
        o = ring_mod.ring_attention(q, k, v, group=group, n=n, rank=rank, impl=impl)
        o.backward(own[3][rows, :, heads].to(o.dtype))
        return [x.detach().float() for x in (o, q.grad, k.grad, v.grad)]

    before, staged = _k4_counts(), dict(tp.HOST_STAGED)
    got = run("auto")
    sync()
    launches = {k: v - before[k] for k, v in _k4_counts().items()}
    staged = {k: v - staged[k] for k, v in tp.HOST_STAGED.items()}
    # the plain twin a row and 8 heads at a time (rows and heads attend
    # apart): its fp32 scores a pair are 32x smaller than the whole call's
    parts = [[run("plain", torch.float32, slice(r, r + 1), slice(c, c + 8))
              for c in range(0, h, 8)] for r in range(b)]
    want = [torch.cat([torch.cat([p[i] for p in row], 2) for row in parts], 0)
            for i in range(4)]
    del parts
    # errors over the whole sequence: each rank's sums of squares and maxima, combined
    parts = []
    for g, w in zip(got, want):
        parts += [(g - w).pow(2).sum(), w.pow(2).sum()]
    sums = torch.stack(parts)
    dist.all_reduce(sums, group=group)
    maxima = torch.stack([t for g, w in zip(got, want) for t in ((g - w).abs().max(),
                                                                  w.abs().max())])
    dist.all_reduce(maxima, op=dist.ReduceOp.MAX, group=group)
    del want
    # the ring a step (forward and backward) and the rotations' share of it
    rot = {"s": 0.0}
    inner = ring_mod._rotate

    def timed_rotate(*a, **k):
        sync()
        t = time.perf_counter()
        out = inner(*a, **k)
        sync()
        rot["s"] += time.perf_counter() - t
        return out

    ring_mod._rotate = timed_rotate
    steps = []
    try:
        for _ in range(3):
            dist.barrier(group=group)
            sync()
            t = time.perf_counter()
            run("auto")
            sync()
            steps.append(time.perf_counter() - t)
    finally:
        ring_mod._rotate = inner
    # one rank's K4a-c over the whole S beside it (the other rank waits)
    whole = []
    if rank == 0:
        for _ in range(3):
            q, k, v = (x.clone().requires_grad_() for x in full[:3])
            sync()
            t = time.perf_counter()
            o = flash_mod.flash_attention_trainable(q, k, v, True)
            o.backward(full[3])
            sync()
            whole.append(time.perf_counter() - t)
    dist.barrier(group=group)
    return {"launches": launches, "staged": staged, "sq": sums.tolist(), "max": maxima.tolist(),
            "step_s": steps, "rotate_s": rot["s"] / len(steps), "whole_s": whole}


def rank_main_cp(out_dir):
    """One of phase 25's two ranks on the one card (`chip_smoke.py --ranks25 DIR`)."""
    import faulthandler

    import torch.distributed as dist

    from teochat_torch.checkpoint import orbax_io
    from teochat_torch.checkpoint.orbax_io import _as_dtensor
    from teochat_torch.config import MeshConfig
    from teochat_torch.parallel import Sharded, create_mesh, init_distributed, shard_params
    from teochat_torch.parallel import tensor_parallel as tp
    from teochat_torch.parallel.sharding import unshard
    from teochat_torch.train import trainer as trainer_mod
    from teochat_torch.train.train import TrainingArguments, _run_cfg

    faulthandler.enable()
    rank = int(os.environ["RANK"])
    device = init_distributed("cuda", backend="gloo", device=torch.device("cuda", 0),
                              init_method=f"file://{os.path.join(out_dir, 'init')}",
                              rank=rank, world_size=2)
    summary = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    ring_mesh = create_mesh(MeshConfig(1, 1, 1, 2, 1), "cuda")
    summary["ring"] = _ring_alone(rank, ring_mesh.get_group("sequence"))
    log(f"[cp rank {rank}] ring alone: {summary['ring']['step_s']} s a step")
    for tag, shape, mb, steps in P25_RUNS:
        cfg = p25_config(tag)
        mesh = create_mesh(MeshConfig(*shape), "cuda")
        run_cfg = _run_cfg(cfg, TrainingArguments(mesh=MeshConfig(*shape),
                                                  pipeline_microbatches=mb))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = shard_params(p24_params(cfg, device), mesh, cfg)
        sharded = Sharded(mesh, cfg, params)
        state = trainer_mod.init_train_state(params, trainer_mod.make_optimizer(**P24_OPT),
                                             lora_trainable_filter)
        before, staged = _k4_all(), dict(tp.HOST_STAGED)
        grads = {}
        with _CommTimer() as comm:
            state, losses, secs = p24_steps(run_cfg, state, p25_batches(cfg, tag, steps), device,
                                            sharded, grads=grads)
        counts = torch.tensor([v - before[k] for k, v in _k4_all().items()], dtype=torch.int64)
        dist.all_reduce(counts)  # the two ranks' launches together
        entry = {"losses": losses, "step_s": secs, "comm_s": comm.seconds,
                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                 "launches": dict(zip(_k4_all(), counts.tolist())),
                 "staged": {k: v - staged[k] for k, v in tp.HOST_STAGED.items()}}
        if tag == "pipe_m2":  # (f): the sharded save of a pipe mesh
            dist.barrier()
            t = time.perf_counter()
            orbax_io.save_checkpoint(os.path.join(out_dir, "ckpt"), state.params, cfg,
                                     opt_state=state.opt_state, step=steps)
            entry["save_s"] = time.perf_counter() - t
            dist.barrier()
        like = dict(tree_leaves_with_path(state.params))
        leaves = {p: unshard(x, p, cfg).float().cpu() for p, x in like.items()
                  if lora_trainable_filter(p)}
        grads = {p: unshard(_as_dtensor(g.contiguous(), like[p]), p, cfg).float().cpu()
                 for p, g in grads.items()}
        log(f"[cp rank {rank}] {tag} {shape}: losses {losses}, s a step {secs}")
        if rank == 0:
            torch.save({"entry": entry, "leaves": leaves, "grads": grads},
                       os.path.join(out_dir, f"cp_{tag}.pt"))
        del state, params, sharded, leaves, grads, like
    if rank == 0:
        with open(os.path.join(out_dir, "ranks.json"), "w") as f:
            json.dump(summary, f)
    dist.destroy_process_group()


def _p25_reference(tag, device):
    """One rank's run of a phase-25 configuration on the same batches: the
    seed's trained leaves, the losses, the first step's gradients, the
    leaves after the steps, s a step and the peak."""
    from teochat_torch.train import trainer as trainer_mod

    _, shape, _, steps = next(r for r in P25_RUNS if r[0] == tag)
    cfg = p25_config(tag)
    params = p24_params(cfg, device)
    before = _trained_leaves(params)
    state = trainer_mod.init_train_state(params, trainer_mod.make_optimizer(**P24_OPT),
                                         lora_trainable_filter)
    torch.cuda.reset_peak_memory_stats()
    grads = {}
    state, losses, secs = p24_steps(cfg, state, p25_batches(cfg, tag, steps), device,
                                    grads=grads)
    out = {"before": before, "losses": losses, "step_s": secs,
           "grads": {p: g.float().cpu() for p, g in grads.items()},
           "leaves": _trained_leaves(state.params),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del state, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_context_pipe(gen):
    """Phase 25: (a) the point-to-point transport, (b) the ring alone at
    LLaMA-7B's attention shape on K4a-c against the plain twin, (c) the
    recipe on mesh (1, 1, 1, sequence 2), (d) on (1, 1, 1, 1, pipe 2) at 2
    and 4 microbatches, (e) LLaVA-MPT-7B's width on pipe 2 (K4a-c with the
    bias), each against one rank's run on the same batches, (f) the pipe
    mesh's sharded save loaded on one process. Two ranks of this script
    share the card over gloo (phase 24's launcher). Returns (the K4a-c
    launches of (c)-(e), with and without the bias; the JSON entry)."""
    from teochat_torch.checkpoint import orbax_io
    from teochat_torch.train import trainer as trainer_mod

    t0 = time.perf_counter()
    device = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"[cp] before the ranks: this process allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB, reserved "
        f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB; the card {free / 2**30:.2f} of "
        f"{total / 2**30:.2f} GiB free")
    refs = {tag: _p25_reference(tag, device) for tag in ("seq", "pipe_m2", "mpt")}
    refs["pipe_m4"] = refs["pipe_m2"]  # one rank has no microbatches: the same run
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_cp_", dir="results")
    entries, launches = {}, dict.fromkeys(_k4_all(), 0)
    try:
        ranks_s = run_ranks("--ranks25", out_dir, "phase 25")
        with open(os.path.join(out_dir, "ranks.json")) as f:
            summary = json.load(f)
        # (a), (b)
        ring = summary["ring"]
        sq, mx = ring["sq"], ring["max"]
        errs = {name: (np.sqrt(sq[2 * i] / sq[2 * i + 1]), mx[2 * i] / mx[2 * i + 1], mx[2 * i])
                for i, name in enumerate(("o", "dq", "dk", "dv"))}
        n = 2
        want_launches = n * (n + 1) // 2
        b, s, h, d = P25_RING
        ring_ms = 1e3 * statistics.median(ring["step_s"])
        whole_ms = 1e3 * statistics.median(ring["whole_s"])
        log(f"[cp] (a) transport: gloo over CUDA tensors on two ranks of cuda:0 (NCCL refuses "
            f"two ranks on one device); gloo's send / recv and batch_isend_irecv abort on CUDA "
            f"tensors ('writev ... Bad address', chip_probe.py two-ranks), so the ring's "
            f"rotations and the pipeline's sends are copied through pinned host buffers "
            f"(parallel/tensor_parallel.py::exchange): the ring alone staged "
            f"{ring['staged']['calls']} exchanges, {ring['staged']['bytes'] / 2**20:.1f} MiB "
            f"on rank 0")
        log(f"[cp] (b) the ring alone, B {b} S {s} split {n} x {s // n}, H {h} D {d}, causal, "
            f"on K4a-c against the plain twin (fp32) on the same bf16 inputs: o max abs err "
            f"{errs['o'][2]:.3e} (bound {FLASH_TOL}); dq / dk / dv rel L2 "
            f"{errs['dq'][0]:.3e} / {errs['dk'][0]:.3e} / {errs['dv'][0]:.3e} (bound "
            f"{GRAD_REL_L2}), rel max {errs['dq'][1]:.3e} / {errs['dk'][1]:.3e} / "
            f"{errs['dv'][1]:.3e} (bound {GRAD_REL_MAX}); launches on rank 0 "
            f"{ring['launches']} (both ranks: K4a, K4b, K4c {want_launches} each); "
            f"{ring_ms:.3f} ms a step (forward and backward, median of "
            f"{len(ring['step_s'])}), the rotations (staged copies and the wait for the "
            f"other rank included) {1e3 * ring['rotate_s']:.3f} ms a step, "
            f"{ring['rotate_s'] / statistics.mean(ring['step_s']):.1%} of the mean step; one "
            f"rank's K4a-c over the whole S {whole_ms:.3f} ms")
        check(errs["o"][2] <= FLASH_TOL, f"ring output err {errs['o'][2]}")
        for name in ("dq", "dk", "dv"):
            check(errs[name][0] <= GRAD_REL_L2 and errs[name][1] <= GRAD_REL_MAX,
                  f"ring {name} rel L2 {errs[name][0]}, rel max {errs[name][1]}")
        # (c)-(e)
        for tag, shape, mb, steps in P25_RUNS:
            got = torch.load(os.path.join(out_dir, f"cp_{tag}.pt"), weights_only=False)
            e, ref = got["entry"], refs[tag]
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(e["losses"], ref["losses"]))
            grad_rels = {p: _rel(got["grads"][p], ref["grads"][p]) for p in ref["grads"]}
            leaf_rels = {p: _rel(got["leaves"][p], ref["leaves"][p]) for p in ref["before"]}
            wg, wl = (max(r, key=r.get) for r in (grad_rels, leaf_rels))
            comm = sum(e["comm_s"].values())
            step = sum(e["step_s"])
            cfg = p25_config(tag)
            layers = cfg.llm.n_layers if tag == "mpt" else cfg.llm.num_layers
            rows, seq = len(p25_batches(cfg, tag, 1)[0]), (P25_SEQ if tag == "seq"
                                                           else P25_PIPE_SEQ)
            extra = ""
            if mb is not None:
                p = shape[4]
                extra = (f"; GPipe's bubble (P - 1) / (M + P - 1) = {(p - 1) / (mb + p - 1):.3f} "
                         f"of a stage's slots, the sends and receives (waits included) "
                         f"{e['comm_s']['p2p'] / step:.1%} of the step")
            log(f"[cp] ({'c' if tag == 'seq' else 'e' if tag == 'mpt' else 'd'}) {tag} mesh "
                f"{shape}, {layers} layers at {'MPT' if tag == 'mpt' else 'LLaMA'}-7B width, "
                f"batch {rows} x {seq}, LoRA r128 over int8, remat, {steps} step(s): losses "
                f"{[round(x, 6) for x in e['losses']]} vs one rank's "
                f"{[round(x, 6) for x in ref['losses']]} (max rel {loss_rel:.3e}, bound "
                f"{P24_LOSS_REL}); first step's gradients worst {wg} rel L2 {grad_rels[wg]:.3e} "
                f"(bound {P24_GRAD_REL}); leaves after the steps worst {wl} "
                f"{leaf_rels[wl]:.3e} (bound {P24_LEAF_REL}); s a step {e['step_s']} (one "
                f"rank: {ref['step_s']}); collectives and sends {comm:.3f} s of {step:.3f} "
                f"({e['comm_s']}){extra}; peak {e['peak_gib']:.2f} GiB a rank (one rank "
                f"{ref['peak_gib']:.2f}); launches {e['launches']}; host-staged "
                f"{e['staged']['bytes'] / 2**20:.1f} MiB on rank 0")
            check(loss_rel <= P24_LOSS_REL, f"{tag} loss rel {loss_rel}")
            check(grad_rels[wg] <= P24_GRAD_REL, f"{tag} gradient {wg} {grad_rels[wg]}")
            check(leaf_rels[wl] <= P24_LEAF_REL, f"{tag} leaf {wl} rel {leaf_rels[wl]}")
            lc = e["launches"]
            if tag == "mpt":  # the bias branches only
                check(lc["fwd"] == lc["dkv"] == lc["dq"] == 0 and lc["fwd_bias"] > 0
                      and lc["dkv_bias"] == lc["dq_bias"] > 0, f"MPT pipe launches {lc}")
            else:
                ring_pairs = want_launches if tag == "seq" else 1
                micro = mb or 1
                want = {"fwd": 2 * layers * ring_pairs * micro * steps,
                        "dkv": layers * ring_pairs * micro * steps}
                want["dq"] = want["dkv"]
                check(all(lc[k] == v for k, v in want.items()) and lc["fwd_bias"] == 0,
                      f"{tag} launches {lc}, expected {want}")
            for k in launches:
                launches[k] += lc[k]
            entries[tag] = {**e, "loss_rel": loss_rel, "worst_grad": wg,
                            "worst_grad_rel_l2": grad_rels[wg], "worst_leaf": wl,
                            "worst_leaf_rel_l2": leaf_rels[wl], "comm_share": comm / step,
                            "reference": {k: ref[k] for k in ("losses", "step_s", "peak_gib")}}
        # (f) the pipe mesh's sharded checkpoint on one process, bitwise
        ckpt = os.path.join(out_dir, "ckpt", f"checkpoint-{P25_STEPS}")
        with open(os.path.join(ckpt, "config.json")) as f:
            saved_llm = json.load(f)["llm"]
        check(saved_llm["pipeline_axis"] is None and saved_llm["sequence_axis"] is None,
              f"the saved config carries the run's axes: {saved_llm}")
        cfg = p24_config()
        params = p24_params(cfg, device)
        template = trainer_mod.init_train_state(params, trainer_mod.make_optimizer(**P24_OPT),
                                                lora_trainable_filter)
        loaded, _, opt = orbax_io.load_checkpoint(ckpt, restore_opt=True,
                                                  params_template=template.params,
                                                  opt_template=template.opt_state)
        flat = dict(tree_leaves_with_path(loaded))
        sharded_leaves = torch.load(os.path.join(out_dir, "cp_pipe_m2.pt"),
                                    weights_only=False)["leaves"]
        for path, x in sharded_leaves.items():
            check(torch.equal(flat[path].float().cpu(), x), f"loaded {path} != the gathered shards")
        for path, x in tree_leaves_with_path(params):
            if not lora_trainable_filter(path):
                check(torch.equal(flat[path], x), f"loaded frozen {path} changed")
        log(f"[cp] (f) the pipe mesh's checkpoint (each stage its layers, saved in "
            f"{entries['pipe_m2']['save_s']:.2f} s) on one process: {len(sharded_leaves)} "
            f"trained leaves bitwise the gathered shards, the frozen ones the seed's, the "
            f"config without pipeline_axis or sequence_axis")
        del params, loaded, opt, template
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {"ring": {**ring, "errors": {k: list(v) for k, v in errs.items()},
                               "ms": ring_ms, "whole_ms": whole_ms},
                      "runs": entries, "ranks_s": ranks_s, "phase_s": time.perf_counter() - t0}


def stamp(t0, what):
    log(f"[time] {time.perf_counter() - t0:.1f} s: {what} done")


def main():
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {"K1": phase_flash(gen), "K2": phase_decode(gen), "K2m": phase_decode_multi(gen)}
    rows["K2 e4m3"], rows["K2m e4m3"] = phase_fp8_kernels(gen)
    k3 = phase_int4(gen)
    rows.update({"K3a": k3["k3a"], "K3b": k3["k3b"], "K3c": k3["k3c"],
                 "K3c M<=8": k3["k3c_decode"]})
    rows["K5"] = phase_vit_attention(gen)
    extras = {"w8a8_projections": phase_w8a8_projections(gen), "w8a8_tower": phase_w8a8_tower(gen),
              "towers": phase_towers(gen)}
    gc.collect()
    torch.cuda.empty_cache()
    stamp(t0, "phases 1-6 and 21 (a), (b), (e)")
    # the MPT phase draws from its own generator: the later phases' weights stay as they were
    mpt_gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    rows["K1 bias"], mpt_kernels = phase_mpt_kernels(mpt_gen)
    mpt_counts, mpt_entry, mpt_model = phase_mpt(mpt_gen)
    mpt_entry.update(mpt_kernels)
    stamp(t0, "phase 22 (MPT)")
    k4_bias_rows, k4_bias_extra = phase_mpt_train_kernels(mpt_gen)
    k4_bias_launches, mpt_entry["train"] = phase_mpt_train(mpt_model, mpt_gen)
    mpt_entry["train"].update(k4_bias_extra)
    del mpt_model
    gen_mod.clear_decode_graphs()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[mpt] after the model is deleted: allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    stamp(t0, "phase 23 (MPT training)")
    tokenizer = WordTokenizer()

    int4_counts, k3a_counts, (fp8_int4, fp8_launches) = phase_int4_path(gen, tokenizer)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[int4] after the model is deleted: {len(gen_mod.decode_graphs())} decode graphs "
        f"live, allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    check(not gen_mod.decode_graphs(), "decode graphs outlived their params")
    stamp(t0, "phases 7-9")

    # the int8 model of the phases below is a checkpoint written here and
    # loaded through the eval driver; the directory is removed at the end
    os.makedirs("results", exist_ok=True)
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir="results")
    try:
        model, hf_tokenizer, image_processor, _, eval_entry = phase_checkpoint_eval(gen, ckpt_root)
        stamp(t0, "phase 10")
        cfg, params = model.cfg, model.params
        processor = FrameProcessor(cfg.vision.image_size, SEED)
        (ids, frames), int8_counts = counted(
            "main", lambda: phase_main_path(model, hf_tokenizer, processor))
        check(all(int8_counts[k] > 0 for k in ("K1", "K2", "K5")),
              f"int8 path launches {int8_counts}")
        phase_decode_graph(model, hf_tokenizer, processor, ids, frames, "main", batch16=False)
        # phase 7 ran the same checks at every k on int4; here k 4 alone
        phase_spec(model, hf_tokenizer, processor, ids, frames, "main", ks=(4,), sweep=(0, 4))
        fp8_int8, _ = phase_fp8_generate(model, hf_tokenizer, processor, "main", batches=(32,))
        phase_logits(model, ids, frames)
        stamp(t0, "phase 11")
        extras["w8a8_prefill"] = phase_w8a8_prefill(model, hf_tokenizer, ids, frames)
        extras["vision_tokens"] = phase_vision_tokens(
            ckpt_root, os.path.join(ckpt_root, "TEOChat-7B"), eval_entry)
        stamp(t0, "phase 21 (c), (d)")
        serve_k2m = phase_server(model, hf_tokenizer, image_processor)
        stamp(t0, "phase 12")
        engine_entry = phase_engine(model, hf_tokenizer, image_processor)
        stamp(t0, "phase 13")
        gen_mod.clear_decode_graphs()
        lora_entry, lora_dirs = phase_multi_lora(model, hf_tokenizer, image_processor, ckpt_root,
                                                 ids, frames, gen)
        stamp(t0, "multi-LoRA")
        engine_entry["int4"] = phase_checkpoint_int4(ckpt_root, lora_dirs)
        lora_entry["int4_step_ms"] = engine_entry["int4"].pop("multi_lora_step_ms")
        gen_mod.clear_decode_graphs()  # training starts from the model's own memory
        gc.collect()
        torch.cuda.empty_cache()
        stamp(t0, "phase 14")
        train_launches, train_entry = phase_train_cli(
            ckpt_root, os.path.join(ckpt_root, "TEOChat-7B"), model)
        stamp(t0, "phase 16")
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    gen_mod.clear_decode_graphs()  # training starts from the model's own memory
    gc.collect()
    torch.cuda.empty_cache()

    k4_rows = phase_flash_backward(gen)
    phase_train_parity(cfg, params, tokenizer, processor, gen)
    engine_entry["e"] = phase_engine_echo(model)  # the last use: it changes the weights
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[main] after the model is deleted: {len(gen_mod.decode_graphs())} decode graphs "
        f"live, allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB")

    stamp(t0, "phases 15-17")
    mesh_launches, mesh_entry = phase_mesh(gen)
    tower_launches, mesh_entry["tower"] = phase_tower_train(gen)
    stamp(t0, "phase 24 (the mesh, the tower trained)")
    cp_launches, mesh_entry["context_pipe"] = phase_context_pipe(gen)
    for k in ("fwd", "dkv", "dq"):
        train_launches[k] += mesh_launches[k] + tower_launches[k] + cp_launches[k]
        k4_bias_launches[k] += cp_launches[f"{k}_bias"]
    stamp(t0, "phase 25 (the ring, the pipeline)")
    s_rows = {**phase_bench_int4(gen), **phase_bench_vit(gen)}
    bench_counts, bench_train = phase_bench_run()
    stamp(t0, "phases 18-20")

    def row(name, source, replaces, launches, measured, where="teochat_tpu/ops/"):
        return {"name": name, "route": "cuda", "source": f"teochat_torch/csrc/{source}",
                "replaces": where + replaces, "launches": launches, **measured}

    def bench_row(key, source, replaces):
        name = "bench_" + key.replace("S1-", "int4_").replace("S2-", "vit_attention_")
        return row(name, source, replaces, bench_counts[key], s_rows[key], where="scripts/")

    # launches: K1, K2, K3b, K3c (its prefill's M > 8 kernel and its decode's
    # kernel apart), K5 on the int4 path and phase 24's ranks, K3a on its own
    # request, K4a-c in phase 16's train() and phase 24's runs, the benches'
    # variants in their benches; the int8 path's and the main bench's counts
    # are checked above
    kernels = [
        row("flash_attention", "flash_attention.cu", "flash_attention.py:32",
            int4_counts["K1"], rows["K1"]),
        # the same kernel's bias branch (`has_bias_k`): the MPT request's prefill
        row("flash_attention_bias", "flash_attention.cu", "flash_attention.py:32",
            mpt_counts["K1 bias"], rows["K1 bias"]),
        row("decode_attention", "decode_attention.cu", "decode_attention.py:44",
            int4_counts["K2"], rows["K2"]),
        # no Pallas kernel: XLA's masked attention in the JAX cached path
        row("decode_attention_multi", "decode_attention.cu", "models/llama.py:316",
            serve_k2m, rows["K2m"], where="teochat_tpu/"),
        # the same two over an e4m3 cache: launches of the int4 path's e4m3
        # generate and of the e4m3 engine's two runs
        row("decode_attention_e4m3", "decode_attention.cu", "decode_attention.py:44",
            fp8_launches, rows["K2 e4m3"]),
        row("decode_attention_multi_e4m3", "decode_attention.cu", "models/llama.py:316",
            engine_entry["fp8"]["k2m_e4m3_launches"], rows["K2m e4m3"], where="teochat_tpu/"),
        row("flash_attention_fwd_res", "flash_attention.cu", "flash_attention.py:243",
            train_launches["fwd"], k4_rows["fwd"]),
        row("flash_attention_bwd_dkv", "flash_attention_bwd.cu", "flash_attention.py:348",
            train_launches["dkv"], k4_rows["dkv"]),
        row("flash_attention_bwd_dq", "flash_attention_bwd.cu", "flash_attention.py:421",
            train_launches["dq"], k4_rows["dq"]),
        # the same three kernels' bias branches (`has_bias_k`): MPT training's
        row("flash_attention_fwd_res_bias", "flash_attention.cu", "flash_attention.py:243",
            k4_bias_launches["fwd"], k4_bias_rows["fwd"]),
        row("flash_attention_bwd_dkv_bias", "flash_attention_bwd.cu", "flash_attention.py:348",
            k4_bias_launches["dkv"], k4_bias_rows["dkv"]),
        row("flash_attention_bwd_dq_bias", "flash_attention_bwd.cu", "flash_attention.py:421",
            k4_bias_launches["dq"], k4_bias_rows["dq"]),
        row("int4_matmul", "int4_matmul.cu", "int4_matmul.py:44",
            k3a_counts["K3a"], rows["K3a"]),
        row("int4_matmul_tiled", "int4_matmul.cu", "int4_matmul.py:208",
            int4_counts["K3b"], rows["K3b"]),
        row("int4_matmul_tiled_stacked", "int4_matmul.cu", "int4_matmul.py:348",
            int4_counts["K3c"] - int4_counts["K3c M<=8"], rows["K3c"]),
        row("int4_matmul_tiled_stacked_decode", "int4_matmul.cu", "int4_matmul.py:348",
            int4_counts["K3c M<=8"], rows["K3c M<=8"]),
        row("vit_attention", "vit_attention.cu", "vit_attention.py:42",
            int4_counts["K5"] + mesh_launches["K5"], rows["K5"]),
        bench_row("S1-v2", "bench_int4_kernel.cu", "bench_int4_kernel.py:55"),
        bench_row("S1-v3", "bench_int4_kernel.cu", "bench_int4_kernel.py:135"),
        bench_row("S1-v4", "bench_int4_kernel.cu", "bench_int4_kernel.py:219"),
        bench_row("S1-v5", "bench_int4_kernel.cu", "bench_int4_kernel.py:281"),
        bench_row("S1-vpu", "bench_int4_kernel.cu", "bench_int4_kernel.py:342"),
        bench_row("S1-dma", "bench_int4_kernel.cu", "bench_int4_kernel.py:383"),
        bench_row("S2-b", "bench_vit_attention.cu", "bench_vit_attention.py:36"),
        bench_row("S2-c", "bench_vit_attention.cu", "bench_vit_attention.py:76"),
    ]
    print(json.dumps({"kernels": kernels, "engine": engine_entry, "eval": eval_entry,
                      "fp8_generate": {"int4": fp8_int4, "int8": fp8_int8},
                      "multi_lora": lora_entry, "mpt": mpt_entry, "mesh": mesh_entry,
                      "train": {**train_entry, "bench": bench_train}, "vision_extras": extras}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ranks"]:  # one of phase 24's ranks
        rank_main(sys.argv[2])
    elif sys.argv[1:2] == ["--ranks25"]:  # one of phase 25's ranks
        rank_main_cp(sys.argv[2])
    else:
        main()
    sys.exit(0)
