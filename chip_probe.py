"""Measurements of the PyTorch / CUDA port on one NVIDIA card, beside the smoke.

    python3 chip_probe.py decode [--root DIR] [--quant int8 int4] [--batches 1 8] [--profile]
                                 [--chunks 1 2 4 8]
    python3 chip_probe.py decode-ttft [--root DIR] [--quant int8 int4] [--reps 9]
    python3 chip_probe.py decode-paths [--turns 3]
    python3 chip_probe.py spec [--quant int8 int4] [--batches 1 4] [--ks 1 2 ... 8]
                               [--rates 0.75 0.5 0.25] [--chunks 1 2 4] [--reps 3]
    python3 chip_probe.py parity [--seeds 0 1] [--layers 32 4] [--pairs auto:plain ...]
    python3 chip_probe.py k1
    python3 chip_probe.py k2m [--root DIR] [--sweep]
    python3 chip_probe.py k4
    python3 chip_probe.py k1k4a [--root DIR] [--tiles 64x64 128x128 ...] [--long]
    python3 chip_probe.py k4bc [--root DIR] [--variants dqbk=128,stages=2 stages=4 ...] [--long]
                               [--bias]
    python3 chip_probe.py train-step [--root DIR]
    python3 chip_probe.py int8-proj [--root DIR]
    python3 chip_probe.py k3k5
    python3 chip_probe.py k3 [--root DIR] [--ms 1 2 4 8 16 768] [--ttft]
    python3 chip_probe.py k5k2 [--root DIR] [--chunks 32 128]
    python3 chip_probe.py s1s2 [--root DIR]
    python3 chip_probe.py s1-ring
    python3 chip_probe.py profile-train
    python3 chip_probe.py two-ranks

Each command prints the card's name and power limit first, then its lines.
`--root` (every command) imports `teochat_torch` and `chip_smoke` from
another checkout, so two trees can be timed in one session on one card.

- two-ranks: two processes of this script on the one card, gloo and then
  NCCL: which backend runs the mesh's collectives (all-gather,
  reduce-scatter, all-reduce, broadcast) on CUDA tensors; then, each in a
  pair of its own (a crash ends only its pair), the point-to-point
  operations the ring and the pipeline would take on CUDA tensors
  (`send` / `recv`, `batch_isend_irecv`, `all_to_all_single`), each rank's
  exit, whether it received its neighbour's values, and its last error
  (phases 24 and 25 of the smoke put their two ranks on gloo).
- decode: the main bench's decode set-up (`teochat_torch.bench.main`: the
  2-frame prompt of 640 fused tokens on stand-in embeddings, a random
  LLaMA-7B decoder from seed 0, greedy, never stopping) at each batch size
  of --batches, for each weight format of --quant in turn (int4 is the
  fused packed decoder with its int4 lm_head): prefill + first token and ms
  per decode step, from the median wall time of `generate_tokens` with 1
  and with 33 new tokens over --reps runs, and the peak memory. A tree
  whose decode steps replay a CUDA graph also prints the capture's time
  (once a key: the warm-up makes it) and the replays the timed generates
  ran; an older tree says "eager loop". Also the allocator's segments made
  in the timed generates (cudaMalloc calls) and which 1-token requests
  made them, and prefill + first token also timed back to back before the
  first 33-token generate and after the timed ones. `--profile` adds `torch.profiler`
  over one generate of 1 and one of 33 tokens: the device's kernel time a
  decode step (their difference over the 32 steps) by kernel class, and its
  share of the same profiled generates' wall time; the 1-token request's
  kernel time, kernels, wall and its host time by op. `--chunks 1 2 4 8` (a tree with the
  graph, batch 1) times the decode loop at each chunk size (iterations
  between two host reads of `done`), never stopping and stopping at an
  EOS near the 18th token. One process, one card: int8 and int4 are read
  side by side. `--root` needs a tree that has the bench.
- decode-ttft: prefill + first token (1-token requests, batch 1) in phases
  of one process: before any 33-token generate, after `empty_cache`, after
  cuBLAS's workspaces are cleared, after a 33-token generate, after the
  decode graphs are dropped (a tree with them), after a second; each
  phase's wall times, allocator segments made, one request's kernel time
  under the profiler (CUDA activity only), and the card's SM clock and
  power from `nvidia-smi` sampled every 100 ms.
- decode-paths: one int8 model, one process: ms per decode step of the
  smoke's 2-frame request through `TEOChat.generate` and of the bench's
  decode set-up, in turns, so that the two can be told from the host's
  spread.
- spec: prompt-lookup speculative decoding on the bench's decode set-up (the
  2-frame prompt of 640 fused tokens on stand-in embeddings, a random
  LLaMA-7B decoder from seed 0, greedy, never stopping), its text a cycle
  of five ids, for each weight format of --quant, batch of --batches and k
  of --ks: ms per verify iteration (the graphed loop's generates of 33 and
  17 tokens, their difference over their difference in iterations;
  medians of --reps) beside the plain graphed step measured the same way,
  and tokens an iteration for the model's own greedy targets, for an
  oracle that continues the cycle (every verbatim draft accepted) and for
  that oracle with drafts corrupted to each keep rate of --rates; the peak
  memory. `--chunks` then times, at batch 1 and k 4 on the first format,
  each SPEC_CHUNK (iterations between two host reads of `done`): a
  generate of 33 tokens that never stops and one whose oracle lets it end
  after 7 iterations.
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
- k4bc: the flash backward alone at the table's shape (B4 S1024 H32 D128,
  causal; `--long` adds a GQA shape and B1 S4096): SASS counts of the tree's
  backward kernels, the di preamble (the torch line in a tree from before
  it), K4b and K4c as the wrappers launch them, the library's one backward
  call on the same inputs, and, where the tree's source has the macros, the
  same source built for each of --variants (`dqbk` K4c's kv tile, which at
  128 keys leaves shared memory for two stages; `stages` the rings' depth), with ptxas's registers, spills and warnings, each held
  to the tree's own gradients.
  With `--root` on a parent checkout and once without, both are read in one
  run on one card. `--bias` also times K4a, K4b and K4c with MPT-7B's ALiBi
  table (sized to S, as in training) at each shape beside the bias-free
  kernels on the same inputs, each bias branch's gradients held to the
  tile walks; a tree whose backward takes no table says so and times the
  bias-free kernels alone.
- train-step: the smoke's training phase alone (`train()` for three
  optimizer steps at 7B width): s a step and tokens/s; with `--root`, a
  parent's beside the tree's in one call.
- int8-proj: what the int8 projection's roundings cost, at the 7B decoder's
  seven projection shapes. (a) One cuBLAS product with a bf16 and with an
  fp32 result at M 1, 8, 640 and 4096. (b) The tree's `quantized_proj` 224
  times at M 1 (one decode step's projections), device drained. (c) The
  backward's dx = (dy * scale) @ W^T at M 4096 with dy * scale rounded to
  bf16 as the product's operand (the port before it kept the operand
  whole), as the tree computes it (`ops/quant.py::mm_fp32_operand` where it
  exists), and the fp32 operand split into a bf16 head and a bf16
  remainder three ways: stacked along the reduction against two copies of
  W^T (one product, one fp32 accumulator), as two products of which the
  second accumulates into the first's fp32 result (`torch.addmm` with
  `out_dtype`, where the card's torch offers it), and stacked as rows (one
  product, then an fp32 add of the two halves): ms a product, ms an
  optimizer step of the recipe (32 layers, 2 micro-steps), and for each how
  many of 256 dx values lie a bf16 step from the exact sum's rounding.
- k2m: decode attention's multi-query form (K2m) on the smoke's K2M_CASES,
  read from this checkout's `chip_smoke.py` (a session's suffix over a
  4,096-slot cache, verify blocks of S 2 and 5 over a full one): SASS
  counts and ptxas's report of `decode_multi_kernel`, then for each case the
  kernel as the wrapper launches it (ms, its error against the plain
  version, a second call bit-equal, 0 where no slot is live; where the
  tree's smoke has `k2m_errors`, each (query, head) row's error over its
  largest |o| against the plain version and the walk, held to the smoke's
  bounds), its row tile and slot splits, SDPA with a boolean mask and the
  bound; exits nonzero where a case fails. With `--root` on a parent
  checkout and once without, both kernels are timed on the same cases in
  one call on one card; with `--root` on a copy whose kernel has a planted
  fault, it shows which bound catches it. `--sweep` adds, for each case at
  batch 1, the wrapper on the cache slab beside the same on a contiguous
  [B, Hkv, T, D] copy (the layout's cost), and every row-group and split
  count through the C entry (the plan `multi_plan` picks is starred).
- k3k5: the smoke's K3 and K5 phases (the int4 products and the ViT attention
  against their plain versions at the 7B shapes); exits nonzero where one
  fails, after running both.
- k3: the int4 product alone at the 7B decoder's four projection shapes
  (q|k|v, out, gate|up, down on K3c: v3 tiles from the port's quantizer,
  the layer picked from a stack of copies larger than the L2), the lm_head
  (K3b) and an unfused 256-wide k or v (K3a, flat u8), each over copies of
  its weight larger than the L2: SASS counts of the tree's int4 kernels
  (`HGMMA`, `UTMALDG`, `HMMA`, `LDG.128`, `PRMT`) and ptxas's registers and
  spills for each; for each M of --ms, the kernel as the wrappers launch it
  (ms, TFLOP/s, GB/s, share of the bound, the error against the plain
  version) and `torch._weight_int4pack_mm` on the same weights where the
  tree's smoke sets it up, both timed over as many copies of their weights;
  beside them the kernel at M 1 on one copy of its weight (L2-warm after
  the first call) and the host time of a call at M 1 (200 calls enqueued
  back to back); then one decode step's K3 device time at batch 1, the
  129 launches summed
  (32 layers of the four K3c shapes and the lm_head), for the kernel and
  the library. `--ttft` adds the `decode` command's int4 and int8 prefill +
  first token at batch 1. With `--root` on a parent checkout and
  once without, both trees are read in one call on one card.
- k5k2: the ViT attention (K5) and the decode attention (K2) alone at the
  kernel table's shapes: SASS counts of the tree's two kernels (`HGMMA`,
  `UTMALDG`, `HMMA`, `LDS`; spills from ptxas in the build log), K5 at
  [32,257,16,64], [2,257,16,64] and [16,1024,16,64] and K2 at B1 T801 len
  580 (H 32, D 128) and B8 T1025 ragged, as the wrappers launch them, beside
  `scaled_dot_product_attention` on the same inputs and the bound; K1's own
  kernel non-causal at head_dim 64 on K5's inputs, as a yardstick; and,
  where the tree's source has the macro, K2 built with each slot chunk of
  --chunks (`TEOCHAT_DECODE_CHUNK`), held to the tree's own output. With `--root` on a parent checkout and once without, both trees
  are read in one call on one card.
- s1s2: the S2 attention bench at [32, 257, 16, 64] (S2-b at each bh of
  1, 2, 4, 8, 16, S2-c's call and its kernel alone, K5 and
  `scaled_dot_product_attention` on the same inputs, beside the bound), the
  same at [32, 300, 16, 64] and [8, 832, 16, 64] (two sweeps; S2-b at bh 8),
  the int4 bench's S1 at K 4096, N 11008, M 1 and 8 (v3 with both masks,
  v4, v2, v5, dma, vpu at M 1 with and without its total, K3 as the
  bench's v0 row, and `torch._weight_int4pack_mm` on the same weights,
  beside the bound; tiles rotated out of the L2), the S1 kernels' SASS
  counts (`UBLKCP`, `HMMA`, `I2F`, `I2FP`, `F2F`, ...; the ring kernels at
  M 1 and M 8), then the smoke's phases for the kernel benches' eight
  variants (the int4 ones and the attention ones against their plain
  versions); exits nonzero where one fails, after running both. With `--root` on a parent checkout
  and once without, both trees are read in one call on one card.
- s1-ring: what sets the pace of the int4 bench's ring body (S1-v3, v5, v4,
  dma, vpu) at K 4096, N 11008, M 1, tiles rotated out of the L2: two
  reference streams over the same bytes in one launch (16-byte loads; one
  thread's bulk copies into rings of 2, 4 and 8 stages of 16 KB, 132 items)
  and an empty launch; then v3, v5, v4, dma and vpu as built and rebuilt
  from edited copies of `bench_int4_kernel.cu` (consumers that only load, no
  merge, both, ring depths 2, 3, 6, 8, M 1 on the M > 1 kernels but vpu's),
  each also on the same bytes cut as 132 tiles of 344 rows (one slice a
  tile, nothing to merge).
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
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch


def _import_tree(root: Path):
    """The smoke module of `root`, with `root` first on the import path."""
    sys.path.insert(0, str(root.resolve()))
    return importlib.import_module("chip_smoke")


# ------------------------------------------------------------------ decode


def _segments() -> int:
    """The caching allocator's segments made so far (its cudaMalloc calls)."""
    return torch.cuda.memory_stats().get("segment.all.allocated", 0)


def cmd_decode(smoke, args):
    from teochat_torch.bench import main as bench_main
    from teochat_torch.models import generation as gen_mod

    graphs = getattr(gen_mod, "decode_graphs", None)  # None: a tree whose decode loop is eager
    n_new = 33
    settings = bench_main.Settings(seed=smoke.SEED, decode_new=n_new)
    for quant in args.quant:
        for bs in args.batches:
            torch.cuda.reset_peak_memory_stats()
            with torch.no_grad():
                run_generate, _, prompt_len = bench_main.build_decode_setup(settings, bs, quant)
                run_generate(1)
                first = [smoke.wall(lambda: run_generate(1))[1] for _ in range(args.reps)]
                run_generate(n_new)  # warm-up; a tree with the graph captures it here
                how = "eager loop"
                if graphs is not None:  # (no entry kept here: it must die with the set-up)
                    replays = sum(e.replays for e in graphs())
                    how = ("graph captured in " + ", ".join(
                        f"{e.capture_seconds * 1e3:.1f}" for e in graphs()
                        if e.graph is not None) + " ms")
                segments = _segments()
                t1, tn, made = [], [], []  # made: 1-token requests that made a segment
                for _ in range(args.reps):
                    before = _segments()
                    t1.append(smoke.wall(lambda: run_generate(1))[1])
                    if _segments() > before:
                        made.append(t1[-1])
                    tn.append(smoke.wall(lambda: run_generate(n_new))[1])
                segments = _segments() - segments
                alone = [smoke.wall(lambda: run_generate(1))[1] for _ in range(args.reps)]
                if graphs is not None:
                    how += (f", {sum(e.replays for e in graphs()) - replays} replays in the "
                            f"timed generates")
            steps = n_new - 1
            ttft, full = statistics.median(t1), statistics.median(tn)
            ms_step = (full - ttft) / steps * 1e3
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"[decode] root={args.root} {quant} bs {bs}: prefill of {prompt_len} tokens + "
                  f"first token {ttft * 1e3:.2f} ms (median of {args.reps}, "
                  f"{min(t1) * 1e3:.2f}-{max(t1) * 1e3:.2f}); {steps} decode steps "
                  f"{ms_step:.3f} ms/step, {bs * 1e3 / ms_step:.2f} tok/s (generate of "
                  f"{n_new} tokens: median {full * 1e3:.2f} ms, {min(tn) * 1e3:.2f}-"
                  f"{max(tn) * 1e3:.2f}); {how}; peak allocated {peak:.3f} GiB", flush=True)
            print(f"[decode] root={args.root} {quant} bs {bs}: prefill + first token back to "
                  f"back before the first {n_new}-token generate {_spread(first)}, interleaved "
                  f"with them {_spread(t1)}, back to back after them {_spread(alone)}; "
                  f"{segments} allocator segments made in the timed generates, by "
                  f"{len(made)} of the {len(t1)} interleaved 1-token requests"
                  + (f" ({_spread(made)})" if made else ""), flush=True)
            if args.profile:
                _profile_decode(run_generate, n_new, ms_step, f"{quant} bs {bs}")
            if args.chunks and graphs is not None and bs == 1:
                _chunk_sweep(smoke, gen_mod, run_generate, n_new, ttft, args, f"{quant} bs {bs}")
            del run_generate
            torch.cuda.empty_cache()
            if graphs is not None:
                live = len(graphs())
                print(f"[decode] the set-up deleted: {live} decode graphs live, allocated "
                      f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)


def cmd_spec(smoke, args):
    from teochat_torch.bench import main as bench_main
    from teochat_torch.checkpoint import bridge
    from teochat_torch.constants import IMAGE_TOKEN_INDEX
    from teochat_torch.models import fusion as fusion_mod
    from teochat_torch.models import generation as gen_mod

    st = bench_main.Settings(seed=smoke.SEED)
    cfg, dev, n_new, n_half = st.cfg, st.dev, 33, 17
    cycle = [100, 101, 102, 103, 104]
    text = (cycle * st.text_tokens)[:st.text_tokens]
    ids = [1] + [IMAGE_TOKEN_INDEX, 7] * 2 + text
    stop = gen_mod.StopSpec(keyword_ids=np.zeros((1, 1), np.int32),
                            keyword_lens=np.zeros((1,), np.int32), eos_id=-1)

    def median_wall(fn, reps):
        return statistics.median(smoke.wall(fn)[1] for _ in range(reps))

    for quant in args.quant:
        torch.cuda.reset_peak_memory_stats()
        llm = bridge.init_llama(cfg.llm, st.generator(), dev, st.dtype, quant=quant)
        for b in args.batches:
            plan = fusion_mod.build_fusion_plan([ids] * b, tokens_per_frame=st.tokens_per_frame,
                                                pad_to=st.prompt_len)
            embeds = torch.from_numpy(
                (np.random.RandomState(1).randn(b, st.prompt_len, cfg.llm.hidden_size) * 0.02)
                .astype(np.float32)).to(dev, st.dtype)
            lens, mask, pos = (torch.as_tensor(a, device=dev)
                               for a in (plan.seq_lens, plan.attention_mask, plan.position_ids))
            pids, plens = np.asarray([ids] * b, np.int32), np.full(b, len(ids), np.int32)
            first = len(text) % len(cycle)  # the oracle continues the history's cycle
            oracle = np.asarray([[cycle[(first + i) % len(cycle)] for i in range(n_new)]] * b,
                                np.int32)

            def spec(k, n, **kw):
                if "oracle_ids" in kw:
                    kw["oracle_ids"] = kw["oracle_ids"][:, :n]
                return gen_mod.generate_tokens_spec(
                    llm, cfg.llm, embeds, lens, mask, pos, pids, plens, stop,
                    torch.Generator(device=dev).manual_seed(0), max_new_tokens=n,
                    cache_len=st.prompt_len + n + k + 1, spec_k=k, **kw)

            def plain(n):
                return gen_mod.generate_tokens(
                    llm, cfg.llm, embeds, lens, mask, pos, stop, st.generator(),
                    max_new_tokens=n, temperature=0.0, do_sample=False,
                    cache_len=st.prompt_len + n + 1)

            with torch.no_grad():
                for n in (n_half, n_new):
                    plain(n)
                t_half, t_full = (median_wall(lambda: plain(n), args.reps) for n in (n_half, n_new))
                print(f"[spec] {quant} bs {b}: plain graphed step "
                      f"{(t_full - t_half) / (n_new - n_half) * 1e3:.3f} ms (generates of "
                      f"{n_new} and {n_half} tokens: medians {t_full * 1e3:.2f} / "
                      f"{t_half * 1e3:.2f} ms of {args.reps})", flush=True)
                gen_mod.clear_decode_graphs()
                for k in args.ks:
                    for n in (n_half, n_new):
                        spec(k, n)  # the captures
                    t_half, t_full = (median_wall(lambda: spec(k, n), args.reps)
                                      for n in (n_half, n_new))
                    s_half, s_full = (int(spec(k, n)[2]) for n in (n_half, n_new))
                    ms = (t_full - t_half) / max(s_full - s_half, 1) * 1e3
                    line = (f"[spec] {quant} bs {b} k {k}: {ms:.3f} ms a verify iteration "
                            f"({s_full} and {s_half} iterations in generates of {t_full * 1e3:.2f} "
                            f"/ {t_half * 1e3:.2f} ms); tokens an iteration: own targets "
                            f"{n_new / s_full:.3f}")
                    knobs = [("oracle", dict(oracle_ids=oracle))] + [
                        (f"keep {p}", dict(oracle_ids=oracle, draft_keep_prob=p))
                        for p in args.rates]
                    for name, kw in knobs:
                        tokens, _, steps, accepted = spec(k, n_new, **kw)
                        if not np.array_equal(tokens.cpu().numpy(), oracle):
                            sys.exit(f"[spec] {quant} bs {b} k {k} {name}: not the oracle's tokens")
                        line += (f", {name} {n_new / int(steps):.3f} (acceptance "
                                 f"{int(accepted) / (b * int(steps) * k):.3f})")
                    print(line, flush=True)
                    gen_mod.clear_decode_graphs()
            if args.chunks and b == 1 and quant == args.quant[0]:
                _spec_chunk_sweep(smoke, gen_mod, spec, oracle, n_new, args, quant)
        print(f"[spec] {quant}: peak allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} "
              f"GiB", flush=True)
        del llm
        gen_mod.clear_decode_graphs()
        torch.cuda.empty_cache()


def _spec_chunk_sweep(smoke, gen_mod, spec, oracle, n_new, args, quant):
    """SPEC_CHUNK of --chunks in turn, interleaved over --reps rounds, at k 4
    on the batch-1 set-up: a generate of n_new tokens that never stops
    (the model's own targets: n_new iterations) and one that ends after
    ceil(n_new / 5) iterations (the oracle, every draft accepted)."""
    saved, never, early = gen_mod.SPEC_CHUNK, defaultdict(list), defaultdict(list)
    try:
        with torch.no_grad():
            spec(4, n_new)
            spec(4, n_new, oracle_ids=oracle)
            for _ in range(args.reps):
                for c in args.chunks:
                    gen_mod.SPEC_CHUNK = c
                    never[c].append(smoke.wall(lambda: spec(4, n_new))[1])
                    early[c].append(smoke.wall(lambda: spec(4, n_new, oracle_ids=oracle))[1])
    finally:
        gen_mod.SPEC_CHUNK = saved
    for c in args.chunks:
        print(f"[spec] {quant} k 4 SPEC_CHUNK {c}: never stopping {_spread(never[c])}, ending "
              f"after {-(-n_new // 5)} iterations {_spread(early[c])} (of {args.reps})",
              flush=True)
    gen_mod.clear_decode_graphs()


def _spread(seconds) -> str:
    return (f"median {statistics.median(seconds) * 1e3:.2f} ms ({min(seconds) * 1e3:.2f}-"
            f"{max(seconds) * 1e3:.2f})")


def _chunk_sweep(smoke, gen_mod, run_generate, n_new, ttft, args, tag):
    """Each chunk size of --chunks (iterations between two host reads of
    `done`) set in turn, the sizes interleaved over --reps rounds: the
    generate of n_new tokens that never stops (ms/step against the
    prefill's `ttft`), and one that stops at an EOS: the token of row 0
    whose first place in the never-stopping run lies nearest its 18th, so
    the steps past the stop show (a chunk runs to its end)."""
    with torch.no_grad():
        row = run_generate(n_new)[0].tolist()
    first = {}
    for i, t in enumerate(row):
        first.setdefault(t, i)
    j = min(first.values(), key=lambda i: (abs(i - 17), i))
    stop = gen_mod.StopSpec(keyword_ids=np.zeros((1, 1), np.int32),
                            keyword_lens=np.zeros((1,), np.int32), eos_id=row[j])
    saved = gen_mod.DECODE_CHUNK
    full, early, replays = defaultdict(list), defaultdict(list), {}
    try:
        with torch.no_grad():
            for _ in range(args.reps):
                for k in args.chunks:
                    gen_mod.DECODE_CHUNK = k
                    full[k].append(smoke.wall(lambda: run_generate(n_new))[1])
                    before = sum(e.replays for e in gen_mod.decode_graphs())
                    out, sec = smoke.wall(lambda: run_generate(n_new, stop))
                    early[k].append(sec)
                    replays[k] = sum(e.replays for e in gen_mod.decode_graphs()) - before
                    if out[0, :j + 1].tolist() != row[:j + 1] or out[0, j + 1:].any():
                        sys.exit(f"[decode] {tag} chunk {k}: the request did not stop at "
                                 f"token {j + 1}")
    finally:
        gen_mod.DECODE_CHUNK = saved
    for k in args.chunks:
        ms_step = (statistics.median(full[k]) - ttft) / (n_new - 1) * 1e3
        print(f"[decode] {tag} chunk {k}: never stopping {ms_step:.3f} ms/step (generate of "
              f"{n_new}: median {statistics.median(full[k]) * 1e3:.2f} ms, "
              f"{min(full[k]) * 1e3:.2f}-{max(full[k]) * 1e3:.2f}); stopping at token {j + 1} "
              f"of {n_new}: median {statistics.median(early[k]) * 1e3:.2f} ms "
              f"({min(early[k]) * 1e3:.2f}-{max(early[k]) * 1e3:.2f}), {replays[k]} replays "
              f"(medians of {args.reps})", flush=True)


DECODE_CLASSES = (  # (class, substrings of the kernel's name); the first match wins
    ("K3 int4 decode", ("int4_decode",)), ("K3 int4 M > 8", ("int4_large_m",)),
    ("K2 decode attention", ("decode_split",)), ("K1 flash", ("flash_fwd",)),
    ("K5 ViT attention", ("vit_attention",)), ("GEMM", ("nvjet", "gemm", "xmma", "cutlass")),
    ("copies and dtype converts", ("copy",)), ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized")),
)


def _classes(names):
    classes = defaultdict(float)
    for name, ms in names.items():
        label = next((c for c, keys in DECODE_CLASSES if any(k in name for k in keys)), "other")
        classes[label] += ms
    return classes


def _profile_decode(run_generate, n_new, ms_step, tag):
    """Device kernel time of a decode step, from `torch.profiler` over one
    generate of 1 and one of n_new tokens (their difference over the steps),
    beside the same two generates' wall time under the profiler: the
    device's busy share within the profiled run. Also the unprofiled step
    (the profiler's overhead) and the 1-token request alone: its kernel
    time, kernels and wall. The pair runs twice; the second is read."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):  # the first pays the profiler's own set-up
        by_name, walls, launches = {}, {}, {}
        for n in (1, n_new):
            with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                                      ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run_generate(n)
                torch.cuda.synchronize()
                walls[n] = (time.perf_counter() - t0) * 1e3
            if n == 1:
                top = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:8]
            names = defaultdict(float)
            launches[n] = 0
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    names[e.name] += e.time_range.elapsed_us() / 1e3
                    launches[n] += 1
            by_name[n] = names
    steps = n_new - 1
    step_ms = (sum(by_name[n_new].values()) - sum(by_name[1].values())) / steps
    if step_ms <= 0:
        sys.exit("[decode] the profiler recorded no decode kernels")
    step_wall = (walls[n_new] - walls[1]) / steps
    print(f"[decode] {tag} profile: {step_ms:.3f} ms of device kernel time a step against "
          f"{step_wall:.3f} ms a step of the profiled run's wall time: busy "
          f"{100 * step_ms / step_wall:.1f} % (unprofiled {ms_step:.3f} ms a step)", flush=True)
    one = sum(by_name[1].values())
    print(f"[decode] {tag} profile: the 1-token request: {one:.3f} ms of device kernel time in "
          f"{launches[1]} kernels against {walls[1]:.3f} ms of wall time; " + ", ".join(
              f"{label} {ms:.3f}" for label, ms in sorted(_classes(by_name[1]).items(),
                                                          key=lambda kv: -kv[1])), flush=True)
    print(f"[decode] {tag} profile: the 1-token request's host time by op (self, ms x calls): "
          + ", ".join(f"{a.key} {a.self_cpu_time_total / 1e3:.3f} x{a.count}" for a in top),
          flush=True)
    diff = {name: ms - by_name[1].get(name, 0.0) for name, ms in by_name[n_new].items()}
    for label, ms in sorted(_classes(diff).items(), key=lambda kv: -kv[1]):
        print(f"[decode] {tag} profile:   {label}: {ms / steps:.3f} ms a step "
              f"({100 * ms / steps / step_ms:.1f} %)", flush=True)


class _CardSampler:
    """`nvidia-smi` sampling the card's SM clock (MHz) and power (W) every
    100 ms in a reader thread; `between(t0, t1)` gives the samples taken
    then. A context manager: the process is stopped on exit."""

    def __enter__(self):
        import subprocess
        import threading

        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
             "-lms", "100", "-i", "0"], stdout=subprocess.PIPE, text=True)

        def read():
            for line in self.proc.stdout:
                try:
                    clock, power = (float(v) for v in line.split(","))
                except ValueError:
                    continue
                self.samples.append((time.time(), clock, power))

        self.thread = threading.Thread(target=read, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        self.proc.wait(timeout=10)
        self.thread.join(timeout=10)

    def between(self, t0, t1) -> str:
        got = [(c, w) for t, c, w in self.samples if t0 <= t <= t1]
        if not got:
            return "no nvidia-smi sample"
        clocks, watts = [c for c, _ in got], [w for _, w in got]
        return (f"SM clock median {statistics.median(clocks):.0f} MHz ({min(clocks):.0f}-"
                f"{max(clocks):.0f}), power median {statistics.median(watts):.1f} W "
                f"({len(got)} samples)")


def cmd_decode_ttft(smoke, args):
    """Prefill + first token (1-token requests, batch 1) of the bench's
    decode set-up for each --quant, in phases of one process: before any
    33-token generate; after `torch.cuda.empty_cache()`; after cuBLAS's
    workspaces are cleared (each of which a capture may do); after a
    33-token generate (a tree with the graph captures there); after
    `clear_decode_graphs()` and `empty_cache()` (a tree with the graph);
    after a second 33-token generate. Each phase: --reps requests
    back to back (wall, the allocator segments they made), then one more
    under `torch.profiler` with CUDA activity only (its kernel time and
    kernels), and the card's SM clock and power sampled meanwhile."""
    from torch.profiler import ProfilerActivity, profile

    from teochat_torch.bench import main as bench_main
    from teochat_torch.models import generation as gen_mod

    clear = getattr(gen_mod, "clear_decode_graphs", None)
    settings = bench_main.Settings(seed=smoke.SEED, decode_new=33)
    with _CardSampler() as card:
        for quant in args.quant:
            with torch.no_grad():
                run_generate, _, _ = bench_main.build_decode_setup(settings, 1, quant)
                run_generate(1)
                phases = [("before any 33-token generate", None),
                          ("after torch.cuda.empty_cache", torch.cuda.empty_cache),
                          ("after cuBLAS's workspaces are cleared",
                           torch._C._cuda_clearCublasWorkspaces),
                          ("after a 33-token generate", lambda: run_generate(33))]
                if clear is not None:
                    phases.append(("after clear_decode_graphs + empty_cache",
                                   lambda: (clear(), torch.cuda.empty_cache())))
                phases.append(("after a second 33-token generate", lambda: run_generate(33)))
                for name, before in phases:
                    if before is not None:
                        before()
                        torch.cuda.synchronize()
                    t0, segments = time.time(), _segments()
                    walls = [smoke.wall(lambda: run_generate(1))[1] for _ in range(args.reps)]
                    segments = _segments() - segments
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        run_generate(1)
                        torch.cuda.synchronize()
                    kernels = [e for e in prof.events()
                               if e.device_type == torch.autograd.DeviceType.CUDA]
                    kernel_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
                    live = len(gen_mod.decode_graphs()) if clear is not None else "no"
                    print(f"[decode-ttft] root={args.root} {quant} bs 1, {name}: "
                          f"{_spread(walls)} over {args.reps}; {segments} allocator segments "
                          f"made; profiled request {kernel_ms:.3f} ms of kernels in "
                          f"{len(kernels)}; {live} graphs live; "
                          f"{card.between(t0, time.time())}", flush=True)
            del run_generate
            if clear is not None:
                clear()
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


def _probe_builds(tag, build, source, variants, entries):
    """`source` (a file of csrc/) compiled once for each variant, all at once:
    `variants` maps a label to its extra nvcc flags. Prints what ptxas says of
    each build (registers, spills, warnings, under the kernel's name) and
    returns {label: ctypes library} with `entries` given their signatures."""
    import ctypes
    import subprocess

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (label, flags) in enumerate(variants.items()):
        out = build.BUILD_DIR / f"{tag}_probe_{i}.so"
        procs[label] = (out, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, *flags, "-shared", "-o", str(out),
             str(build.CSRC / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (out, proc) in procs.items():
        log = proc.communicate()[0]
        for line in log.splitlines():
            if "Compiling entry function" in line:
                line = line.split("'")[1] if "'" in line else line
            elif not any(w in line for w in ("registers", "spill", "arning", "rror")):
                continue
            print(f"[{tag}] build {label}: {line.strip()}", flush=True)
        if proc.returncode != 0:
            sys.exit(f"[{tag}] nvcc failed for {label}")
        libs[label] = ctypes.CDLL(str(out))
        libs[label].path = out
        for name in entries:
            fn = getattr(libs[label], name)
            fn.argtypes, fn.restype = build._SIGNATURES[name], ctypes.c_int
    return libs


def _flash_tile_builds(build, tiles):
    """flash_attention.cu compiled once for each (BQ, BK, stages);
    returns {(bq, bk, stages): ctypes library}."""
    variants = {(bq, bk, stages): [f"-DTEOCHAT_FLASH_BQ={bq}", f"-DTEOCHAT_FLASH_BK={bk}",
                                   f"-DTEOCHAT_FLASH_STAGES={stages}"]
                for bq, bk, stages in tiles}
    return _probe_builds("k1k4a", build, "flash_attention.cu", variants,
                         ("teochat_flash_attention_fwd", "teochat_flash_attention_fwd_res"))


SASS_OPCODES = ("HGMMA", "UTMALDG", "HMMA", "LDSM", "LDS", "STS", "LDG", "LDG.128", "LDGSTS",
                "STG", "SYNCS", "MUFU", "FFMA", "SHFL", "PRMT", "BAR", "WARPGROUP")


def _kernel_sass(tag, build, kernels, path=None):
    """Static opcode counts of each kernel whose name holds `kernels`, in the
    tree's built library (or the library at `path`), by `cuobjdump -sass`:
    what the products and the loads compiled to. `WARPGROUP` counts the
    arrive / wait pairs around a run of `HGMMA`: as many as `HGMMA` itself
    means ptxas serialized them."""
    import re
    import shutil
    import subprocess
    from collections import Counter

    tool = shutil.which("cuobjdump") or str(Path(build._nvcc()).with_name("cuobjdump"))
    text = subprocess.run([tool, "-sass", str(path or build.library().path)],
                          capture_output=True, text=True, check=True).stdout
    for block in text.split("Function : ")[1:]:
        name = block.split(None, 1)[0]
        if kernels not in name:
            continue
        full = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?([A-Z][A-Z0-9_.]*)", block)
        ops = Counter(op.split(".")[0] for op in full)
        # 16-byte global loads, whatever their cache modifiers
        ops["LDG.128"] = sum(op.startswith("LDG") and ".128" in op for op in full)
        counts = ", ".join(f"{op} {ops.get(op, 0)}" for op in SASS_OPCODES)
        print(f"[{tag}] sass {name}: {sum(ops.values())} instructions: {counts}", flush=True)


def cmd_k1k4a(smoke, args):
    import torch.nn.functional as F

    from teochat_torch.ops import _build as build
    from teochat_torch.ops import flash_attention as flash_mod

    _kernel_sass("k1k4a", build, "flash_fwd_kernel")
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
            # no bias table: a null pointer and a stride of 0
            tail = (b, s, s, h, h, d, *flash_mod._strides(q, k, v), 0, scale, 1, stream)
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
            if stats:
                run = lambda: lib.teochat_flash_attention_fwd_res(  # noqa: E731
                    *ptrs, m.data_ptr(), l.data_ptr(), 0, *tail)
            else:
                run = lambda: lib.teochat_flash_attention_fwd(*ptrs, 0, *tail)  # noqa: E731
            out.zero_()
            rc = run()
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs().max().item()
            t_ms = smoke.time_ms(run)
            print(f"[k1k4a]   tile BQ={bq} BK={bk} stages={stages}: {t_ms:.4f} ms ({flops / t_ms / 1e9:.1f} "
                  f"TFLOP/s, {t_ms / lib_ms:.2f}x the library call), rc {rc}, max |o - tree's o| "
                  f"{diff:.3e}", flush=True)


# ------------------------------------------------------------------ k4bc

K4BC_MACROS = {"dqbk": "TEOCHAT_FLASH_BWD_DQ_BK", "stages": "TEOCHAT_FLASH_BWD_STAGES"}


def cmd_k4bc(smoke, args):
    import torch.nn.functional as F

    from teochat_torch.ops import _build as build
    from teochat_torch.ops import flash_attention as flash_mod

    _kernel_sass("k4bc", build, "flash_bwd_")
    source = (build.CSRC / "flash_attention_bwd.cu").read_text()
    variants = {}
    for spec in args.variants if "TEOCHAT_FLASH_BWD_DQ_BK" in source else ():
        variants[spec] = [f"-D{K4BC_MACROS[key]}={int(value)}"
                          for key, value in (kv.split("=") for kv in spec.split(","))]
    entries = ("teochat_flash_attention_bwd_dkv", "teochat_flash_attention_bwd_dq")
    libs = _probe_builds("k4bc", build, "flash_attention_bwd.cu", variants, entries)
    for label, lib in libs.items():
        _kernel_sass(f"k4bc {label}", build, "kernelILi128", path=lib.path)
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    d = 128
    scale = d ** -0.5
    shapes = [("B4 S1024", 4, 1024, 32, 32)]
    if args.long:
        shapes += [("B4 S1024 Hkv8", 4, 1024, 32, 8), ("B1 S4096", 1, 4096, 32, 32)]
    for row, b, s, h, hkv in shapes:
        q, do = smoke._randn((b, s, h, d), gen), smoke._randn((b, s, h, d), gen)
        k, v = smoke._randn((b, s, hkv, d), gen), smoke._randn((b, s, hkv, d), gen)
        o, m, l = flash_mod._fwd_res_cuda(q, k, v, True, scale)
        # a tree from before the preamble kernel computes di with torch ops
        di_fn = getattr(flash_mod, "_bwd_di_cuda", None) or (
            lambda o, do: (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous())
        di = di_fn(o, do)
        dk, dv = flash_mod._bwd_dkv_cuda(q, k, v, do, m, l, di, True, scale)
        dq = flash_mod._bwd_dq_cuda(q, k, v, do, m, l, di, True, scale)
        product = 2 * b * h * s * s * d / 2  # one causal S x S x D product
        qt, kt, vt = (smoke._bhsd(x).detach().requires_grad_(True) for x in (q, k, v))
        if hkv == h:
            ol = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            lib_ms = smoke.time_ms(lambda: torch.autograd.grad(
                ol, (qt, kt, vt), smoke._bhsd(do), retain_graph=True))
        else:
            lib_ms = float("nan")  # the library call takes no grouped kv heads as they are
        t_di = smoke.time_ms(lambda: di_fn(o, do))
        t_dkv = smoke.time_ms(lambda: flash_mod._bwd_dkv_cuda(q, k, v, do, m, l, di, True, scale))
        t_dq = smoke.time_ms(lambda: flash_mod._bwd_dq_cuda(q, k, v, do, m, l, di, True, scale))
        total = t_di + t_dkv + t_dq
        print(f"[k4bc] root={args.root} {row} H={h} Hkv={hkv} D={d}: di {t_di:.4f} ms, K4b "
              f"{t_dkv:.4f} ms ({4 * product / t_dkv / 1e9:.1f} TFLOP/s), K4c {t_dq:.4f} ms "
              f"({3 * product / t_dq / 1e9:.1f} TFLOP/s), together {total:.4f} ms; "
              f"scaled_dot_product_attention backward {lib_ms:.4f} ms ({total / lib_ms:.2f}x)",
              flush=True)
        if args.bias:
            _k4bc_bias(smoke, flash_mod, args, row, q, k, v, do, (t_dkv, t_dq), product)
        out_k, out_v, out_q = torch.empty_like(dk), torch.empty_like(dv), torch.empty_like(dq)
        for label, lib in libs.items():
            head = flash_mod._bwd_args(q, k, v, do, m, l, di, True, scale)
            run_dkv = lambda: lib.teochat_flash_attention_bwd_dkv(  # noqa: E731
                *head, out_k.data_ptr(), out_v.data_ptr())
            run_dq = lambda: lib.teochat_flash_attention_bwd_dq(*head, out_q.data_ptr())  # noqa: E731
            for x in (out_k, out_v, out_q):
                x.zero_()
            rcs = (run_dkv(), run_dq())
            torch.cuda.synchronize()
            diff = max((a.float() - b_.float()).abs().max().item()
                       for a, b_ in ((out_k, dk), (out_v, dv), (out_q, dq)))
            v_dkv, v_dq = smoke.time_ms(run_dkv), smoke.time_ms(run_dq)
            print(f"[k4bc]   {label}: K4b {v_dkv:.4f} ms ({4 * product / v_dkv / 1e9:.1f} TFLOP/s), "
                  f"K4c {v_dq:.4f} ms ({3 * product / v_dq / 1e9:.1f} TFLOP/s), rc {rcs}, "
                  f"max |gradient - tree's| {diff:.3e}", flush=True)


def _k4bc_bias(smoke, flash_mod, args, row, q, k, v, do, free_ms, product):
    """K4a, K4b and K4c with MPT-7B's table at one shape beside the bias-free
    K4b and K4c (`free_ms`, timed on the same inputs); the bias branches'
    gradients against their tile walks."""
    import inspect

    from teochat_torch.models import mpt as mpt_mod

    if "bias_k" not in inspect.signature(flash_mod._bwd_dkv_cuda).parameters:
        print(f"[k4bc] root={args.root} {row}: this tree's backward takes no bias table",
              flush=True)
        return
    h, d = q.shape[2], q.shape[3]
    scale = d ** -0.5
    bias = mpt_mod.alibi_bias(h, q.shape[1], device="cuda")[0, :, 0, :]
    t_fwd_free = smoke.time_ms(lambda: flash_mod._fwd_res_cuda(q, k, v, True, scale))
    t_fwd = smoke.time_ms(lambda: flash_mod._fwd_res_cuda(q, k, v, True, scale, bias))
    o, m, l = flash_mod._fwd_res_cuda(q, k, v, True, scale, bias)
    di = flash_mod._bwd_di_cuda(o, do)
    dk, dv = flash_mod._bwd_dkv_cuda(q, k, v, do, m, l, di, True, scale, bias)
    dq = flash_mod._bwd_dq_cuda(q, k, v, do, m, l, di, True, scale, bias)
    want_dk, want_dv = flash_mod.flash_backward_dkv_schedule(q, k, v, do, m, l, di, bias_k=bias)
    want_dq = flash_mod.flash_backward_dq_schedule(q, k, v, do, m, l, di, bias_k=bias)
    rel = ", ".join(
        f"{name} {((g.float() - w.float()).abs().max() / w.float().abs().max()).item():.2e}"
        for name, g, w in (("dq", dq, want_dq), ("dk", dk, want_dk), ("dv", dv, want_dv)))
    t_dkv = smoke.time_ms(lambda: flash_mod._bwd_dkv_cuda(q, k, v, do, m, l, di, True, scale,
                                                          bias))
    t_dq = smoke.time_ms(lambda: flash_mod._bwd_dq_cuda(q, k, v, do, m, l, di, True, scale, bias))
    print(f"[k4bc] root={args.root} {row} with the bias: K4a {t_fwd:.4f} ms (bias-free "
          f"{t_fwd_free:.4f}, x{t_fwd / t_fwd_free:.3f}), K4b {t_dkv:.4f} ms (bias-free "
          f"{free_ms[0]:.4f}, x{t_dkv / free_ms[0]:.3f}; {4 * product / t_dkv / 1e9:.1f} "
          f"TFLOP/s), K4c {t_dq:.4f} ms (bias-free {free_ms[1]:.4f}, x{t_dq / free_ms[1]:.3f}; "
          f"{3 * product / t_dq / 1e9:.1f} TFLOP/s); largest error against the tile walks over "
          f"the largest gradient: {rel}", flush=True)


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


def _k2m_cases():
    """K2M_CASES as this checkout's chip_smoke.py writes them (literals, read
    without importing it), so that a --root tree is timed on the same cases."""
    import ast

    tree = ast.parse((Path(__file__).parent / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(target, "id", None) == "K2M_CASES" for target in node.targets):
            return ast.literal_eval(node.value)
    raise RuntimeError("chip_smoke.py has no K2M_CASES")


def cmd_k2m(smoke, args):
    import torch.nn.functional as F

    from teochat_torch.bench._timing import bound_ms
    from teochat_torch.ops import _build as build
    from teochat_torch.ops import decode_attention as dec_mod

    _kernel_sass("k2m", build, "decode_multi_kernel")
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    failed = False
    for b, s, h, hkv, t, d, starts, live in _k2m_cases():
        k = smoke._randn((b, t, hkv, d), gen).transpose(1, 2)
        v = smoke._randn((b, t, hkv, d), gen).transpose(1, 2)
        q = smoke._randn((b, s, h, d), gen)
        lens = dec_mod.query_lengths(*smoke._suffix_case(b, s, t, starts, live))
        got = dec_mod.decode_attention_multi(q, k, v, lens)
        again = dec_mod.decode_attention_multi(q, k, v, lens)
        alive = lens > 0
        same = torch.equal(got, again) and got[~alive].abs().sum().item() == 0.0
        if hasattr(smoke, "k2m_errors"):
            err, rel, walk_rel = smoke.k2m_errors(q, k, v, lens, got)
            rels = (f", of a row's largest |o| {rel:.3e} (bound {smoke.K2M_REL_MAX}), against "
                    f"the walk {walk_rel:.3e} (bound {smoke.K2M_WALK_REL_MAX})")
            failed |= rel > smoke.K2M_REL_MAX or walk_rel > smoke.K2M_WALK_REL_MAX
        else:  # a tree before the row-scaled bounds
            want = dec_mod.decode_attention_multi_plain(q.float(), k.float(), v.float(), lens)
            err, rels = (got.float() - want)[alive].abs().max().item(), ""
        failed |= not same or err > smoke.DECODE_TOL
        ms = smoke.time_ms(lambda: dec_mod.decode_attention_multi(q, k, v, lens))
        lib = "n/a (a query without live slots)"
        if alive.all():
            mask = torch.arange(t, device="cuda")[None, None, :] < lens[..., None]
            lib_ms = smoke.time_ms(lambda: F.scaled_dot_product_attention(
                smoke._bhsd(q), k, v, attn_mask=mask[:, None], enable_gqa=hkv != h))
            lib = f"{lib_ms:.4f} ms (kernel {ms / lib_ms:.2f}x)"
        plan = "a block a (row, 32 / G queries, G heads), no split"  # the tree before multi_plan
        if hasattr(dec_mod, "multi_plan"):
            rw, splits, _ = dec_mod.multi_plan(b, s, h, hkv, t, build.sm_count(q.device))
            plan = f"rows a block {16 * rw}, splits {splits}"
        kv_read = int(lens.amax(-1).sum().item()) * hkv * d * 2 * 2
        bound, by = bound_ms(kv_read + 2 * 2 * b * s * h * d, 4 * int(lens.sum().item()) * h * d)
        print(f"[k2m] root={args.root} B={b} S={s} H={h} Hkv={hkv} D={d} T={t} starts={starts} "
              f"live={live} ({plan}): kernel {ms:.4f} ms, max_abs_err {err:.3e}{rels}, bit-equal "
              f"and 0 where no slot is live: {same}; scaled_dot_product_attention {lib}; bound "
              f"{bound:.4f} ms ({by})", flush=True)
    if args.sweep:
        _k2m_sweep(smoke, build, dec_mod)
    print(f"[k2m] root={args.root} {'FAILED' if failed else 'passed'}", flush=True)
    sys.exit(1 if failed else 0)


def _k2m_sweep(smoke, build, dec_mod):
    """K2m's launch plans side by side: for each 7B case of K2M_CASES (B 1),
    the C entry called with each row-group count and each split count that
    keeps the blocks within two an SM (its own workspace and tickets), held
    to the wrapper's output."""
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    lib = build.library().lib
    sms = build.sm_count(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    for b, s, h, hkv, t, d, starts, live in _k2m_cases():
        if b != 1 or d != 128 or h != hkv:
            continue
        k = smoke._randn((b, t, hkv, d), gen).transpose(1, 2)
        v = smoke._randn((b, t, hkv, d), gen).transpose(1, 2)
        q = smoke._randn((b, s, h, d), gen)
        lens = dec_mod.query_lengths(*smoke._suffix_case(b, s, t, starts, live))
        ref = dec_mod.decode_attention_multi(q, k, v, lens)
        kc, vc = k.contiguous(), v.contiguous()  # [B, Hkv, T, D]: a kv head's slots adjacent
        print(f"[k2m] sweep S={s} starts={starts} live={live}: the wrapper on the cache slab "
              f"{smoke.time_ms(lambda: dec_mod.decode_attention_multi(q, k, v, lens)):.4f} ms, "
              f"on a contiguous [B, Hkv, T, D] copy "
              f"{smoke.time_ms(lambda: dec_mod.decode_attention_multi(q, kc, vc, lens)):.4f} ms",
              flush=True)
        del kc, vc
        picked = dec_mod.multi_plan(b, s, h, hkv, t, sms)
        n_chunks = -(-t // dec_mod.MULTI_CHUNK)
        out = torch.empty_like(ref)
        part_ml = torch.empty(2 * sms * 64 * 2, device="cuda")
        part_acc = torch.empty(2 * sms * 64 * d, device="cuda")
        tickets = torch.zeros(2 * sms, dtype=torch.int32, device="cuda")
        row = []
        for rw in dec_mod.MULTI_ROW_WARPS:
            tiles = b * hkv * -(-s // (16 * rw))
            for splits in (1, 2, 4, 8, 16):
                split_chunks = -(-n_chunks // splits)
                if -(-n_chunks // split_chunks) != splits or (
                        splits > 1 and tiles * splits > 2 * sms):
                    continue
                run = lambda: lib.teochat_decode_attention_multi(  # noqa: E731
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                    out.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(),
                    tickets.data_ptr(), b, s, h, hkv, t, d, rw, splits, split_chunks,
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], d ** -0.5,
                    stream())
                out.zero_()
                rc = run()
                torch.cuda.synchronize()
                diff = (out.float() - ref.float()).abs().max().item()
                mark = "*" if (rw, splits) == picked[:2] else ""
                row.append(f"rw{rw}/s{splits}{mark} {smoke.time_ms(run):.4f}"
                           + ("" if rc == 0 and diff <= 2e-2 else f" (rc {rc}, diff {diff:.1e})"))
        print(f"[k2m] sweep S={s} starts={starts} live={live}: " + ", ".join(row), flush=True)


def cmd_k3k5(smoke, args):
    _run_phases(smoke, (("k5", smoke.phase_vit_attention), ("k3", smoke.phase_int4)))


# -------------------------------------------------------------------- k3

# the 7B decoder's projections (fan-in, fan-out, entry): q|k|v and gate|up
# fused, out, down (its packed fan-in padded 5504 -> 5632 byte rows) on K3c;
# the lm_head on K3b; an unfused k or v of a model with 2 kv heads on K3a (flat)
K3_SHAPES = (("qkv", 4096, 12288, "K3c"), ("out", 4096, 4096, "K3c"),
             ("gateup", 4096, 22016, "K3c"), ("down", 11008, 4096, "K3c"),
             ("lm_head", 4096, 32000, "K3b"), ("kv", 4096, 256, "K3a"))
# one int4 decode step at batch 1: each projection once a layer, the lm_head once
K3_STEP_LAUNCHES = {"qkv": 32, "out": 32, "gateup": 32, "down": 32, "lm_head": 1}


def _ptxas_report(tag, log, kernel):
    """ptxas's lines (registers, spills) for each entry whose name holds `kernel`."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            name = line.split("'")[1] if "'" in line else line
            for nxt in lines[i + 1:i + 6]:
                if "spill" in nxt or "registers" in nxt:
                    print(f"[{tag}] ptxas {name}: {nxt.strip()}", flush=True)


def cmd_k3(smoke, args):
    from teochat_torch.bench._timing import bound_ms
    from teochat_torch.ops import _build as build
    from teochat_torch.ops import int4_matmul as int4_mod
    from teochat_torch.ops import quant as quant_mod

    tag = f"k3 root={args.root}"
    time_ms = smoke.time_ms
    _kernel_sass(tag, build, "int4_matmul_cu")
    for kernel in ("int4_large_m", "int4_small_m", "int4_decode"):
        _ptxas_report(tag, build.library().log, kernel)
    library = getattr(smoke, "int4pack_library", None)
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    step = {"kernel": 0.0, "library": 0.0}  # ms of one decode step's K3 launches at M 1
    for name, k, n, entry in K3_SHAPES:
        leaf = quant_mod.quantize_kernel_int4(
            torch.randn((k, n), generator=gen, device="cuda") * 0.02)
        packed = leaf["packed"] if entry == "K3a" else leaf["packed_tiles"]
        scale = leaf["scale"]
        k2 = packed.shape[-2]
        reps = -(-160 * 2**20 // packed.numel())  # copies that exceed the L2 three times
        rot = packed[None].expand(reps, *packed.shape).contiguous()
        rot_scale = scale[None].expand(reps, -1).contiguous()
        state = [0]

        def nxt():
            state[0] = (state[0] + 1) % reps
            return state[0]

        if entry == "K3a":
            run = lambda x: int4_mod.int4_matmul(x, rot[nxt()], scale)
        elif entry == "K3b":
            run = lambda x: int4_mod.int4_matmul_tiled(x, rot[nxt()], scale, n_out=n)
        else:
            run = lambda x: int4_mod.int4_matmul_tiled_stacked(x, rot, rot_scale, nxt(), n_out=n)
        # the library's calls walk as many copies of its weights as the kernel's
        lib = library(packed, scale, n, copies=reps) if library else None
        # the kernel at M 1 over one copy that stays in the L2: what the
        # weights' trip from memory adds
        x1 = smoke._randn((1, k), gen)
        if entry == "K3a":
            warm_ms = time_ms(lambda: int4_mod.int4_matmul(x1, packed, scale))
        elif entry == "K3b":
            warm_ms = time_ms(lambda: int4_mod.int4_matmul_tiled(x1, packed, scale, n_out=n))
        else:
            warm_ms = time_ms(lambda: int4_mod.int4_matmul_tiled_stacked(
                x1, packed[None], scale[None], 0, n_out=n))
        print(f"[{tag}] {entry} {name}: the kernel at M 1 on one copy (in the L2 after the "
              f"first call) {warm_ms:.4f} ms", flush=True)
        for m in args.ms:
            x = smoke._randn((m, k), gen)
            if entry == "K3a":
                want = int4_mod.int4_matmul_plain(x.float(), packed, scale)
            else:
                want = int4_mod.int4_matmul_tiled_plain(x.float(), packed, scale, n_out=n)
            got = run(x)
            rel_l2 = ((got.float() - want).norm() / want.norm()).item()
            ms = time_ms(lambda: run(x))
            nbytes = packed.numel() + 2 * m * k + 2 * m * n + 4 * n
            flops = 2 * m * k * n
            bound, by = bound_ms(nbytes, flops)
            lib_text, lib_ms = "none", None
            if lib is not None:
                prepare, call = lib
                xp = prepare(x)
                try:
                    lib_l2 = ((call(xp).float() - want).norm() / want.norm()).item()
                    lib_ms = time_ms(lambda: call(xp))
                    lib_text = f"{lib_ms:.4f} ms (rel L2 {lib_l2:.2e}, {ms / lib_ms:.2f}x)"
                except RuntimeError as e:
                    lib_text = f"none: {str(e)[:160]}"
            if m == 1:  # the wrapper's host time: the eager decode step waits on the host
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):  # fewer than the launch queue holds: nothing blocks
                    run(x)
                host_us = (time.perf_counter() - t0) / 200 * 1e6
                torch.cuda.synchronize()
                print(f"[{tag}] {entry} {name} M=1: {host_us:.1f} us of host time a call (200 "
                      f"calls enqueued back to back)", flush=True)
            if m == 1 and name in K3_STEP_LAUNCHES:
                step["kernel"] += K3_STEP_LAUNCHES[name] * ms
                step["library"] += K3_STEP_LAUNCHES[name] * (lib_ms or float("nan"))
            print(f"[{tag}] {entry} {name} K={k} k2={k2} N={n} M={m}: kernel {ms:.4f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e6:.1f} GB/s, "
                  f"{bound / ms:.3f} of the bound), rel L2 {rel_l2:.2e}; bound {bound:.4f} ms "
                  f"({by}); torch._weight_int4pack_mm {lib_text}", flush=True)
        del rot, rot_scale, lib
        torch.cuda.empty_cache()
    if 1 in args.ms:
        n_launches = sum(K3_STEP_LAUNCHES.values())
        print(f"[{tag}] int4 decode step at batch 1, K3's {n_launches} launches (32 layers x "
              f"q|k|v, out, gate|up, down on K3c + the lm_head on K3b): kernel "
              f"{step['kernel']:.4f} ms, torch._weight_int4pack_mm {step['library']:.4f} ms",
              flush=True)
    if args.ttft:
        cmd_decode(smoke, argparse.Namespace(root=args.root, reps=5, quant=["int4", "int8"],
                                             batches=[1]))


# ------------------------------------------------------------------ k5k2

K5_SHAPES = ((32, 257), (2, 257), (16, 1024))  # (B, S) at H 16, D 64
K2_SHAPES = (("B1 T801", 32, 801, [580]),
             ("B8 T1025", 32, 1025, [1025, 1, 517, 1024, 64, 300, 1000, 2]))  # (row, H, T, lens)


def cmd_k5k2(smoke, args):
    import torch.nn.functional as F

    from teochat_torch.bench._timing import bound_ms
    from teochat_torch.ops import _build as build
    from teochat_torch.ops import decode_attention as dec_mod
    from teochat_torch.ops import flash_attention as flash_mod
    from teochat_torch.ops import vit_attention as vit_mod

    _kernel_sass("k5k2", build, "vit_attention_kernel")
    _kernel_sass("k5k2", build, "decode_")
    dec_src = (build.CSRC / "decode_attention.cu").read_text()
    dec_libs = _probe_builds("k2", build, "decode_attention.cu", {
        f"chunk={c}": [f"-DTEOCHAT_DECODE_CHUNK={c}"] for c in args.chunks},
        ("teochat_decode_attention",)) if "TEOCHAT_DECODE_CHUNK" in dec_src else {}
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    h, d = 16, 64
    for b, s in K5_SHAPES:
        q, k, v = (smoke._randn((b, s, h, d), gen) for _ in range(3))
        ref = vit_mod.vit_attention(q, k, v)
        want = vit_mod.vit_attention_plain(q.float(), k.float(), v.float())
        err = (ref.float() - want).abs().max().item()
        ms = smoke.time_ms(lambda: vit_mod.vit_attention(q, k, v))
        lib_ms = smoke.time_ms(lambda: F.scaled_dot_product_attention(
            smoke._bhsd(q), smoke._bhsd(k), smoke._bhsd(v)))
        k1_ms = smoke.time_ms(lambda: flash_mod.flash_attention(q, k, v, causal=False))
        bound, by = bound_ms(2 * 4 * b * s * h * d, 4 * b * h * s * s * d)
        print(f"[k5k2] root={args.root} K5 B={b} S={s} H={h} D={d}: kernel {ms:.4f} ms, max_abs_err "
              f"{err:.3e}; scaled_dot_product_attention {lib_ms:.4f} ms ({ms / lib_ms:.2f}x); K1 "
              f"non-causal {k1_ms:.4f} ms; bound {bound:.4f} ms ({by})", flush=True)
    d = 128
    for row, h, t, lengths in K2_SHAPES:
        b = len(lengths)
        k = smoke._randn((b, t, h, d), gen).transpose(1, 2)
        v = smoke._randn((b, t, h, d), gen).transpose(1, 2)
        q = smoke._randn((b, h, d), gen)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        ref = dec_mod.decode_attention(q, k, v, lens)
        want = dec_mod.decode_attention_plain(q.float(), k.float(), v.float(), lens)
        err = (ref.float() - want).abs().max().item()
        ms = smoke.time_ms(lambda: dec_mod.decode_attention(q, k, v, lens))
        mask = torch.arange(t, device="cuda")[None, :] < lens[:, None]
        lib_ms = smoke.time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], k, v, attn_mask=mask[:, None, None, :]))
        nbytes = 2 * int(lens.sum().item()) * h * d * 2
        bound, by = bound_ms(nbytes + 4 * b * h * d, 4 * int(lens.sum().item()) * h * d)
        print(f"[k5k2] root={args.root} K2 {row} H={h} D={d} lengths={lengths}: kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.1f} GB/s of live KV), max_abs_err {err:.3e}; "
              f"scaled_dot_product_attention {lib_ms:.4f} ms ({ms / lib_ms:.2f}x); bound "
              f"{bound:.4f} ms ({by})", flush=True)
        out = torch.empty_like(ref)
        n_chunks = -(-t // min(args.chunks))
        part_ml = torch.empty((b, h, n_chunks, 2), device="cuda")
        part_acc = torch.empty((b, h, n_chunks, d), device="cuda")
        for label, lib in dec_libs.items():
            tickets = torch.zeros(b * h, dtype=torch.int32, device="cuda")
            run = lambda: lib.teochat_decode_attention(  # noqa: E731
                q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
                part_ml.data_ptr(), part_acc.data_ptr(), tickets.data_ptr(), b, h, h, t, d,
                q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3], d ** -0.5, stream())
            out.zero_()
            rc = run()
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs().max().item()
            t_ms = smoke.time_ms(run)
            print(f"[k5k2]   K2 {label}: {t_ms:.4f} ms ({nbytes / t_ms / 1e6:.1f} GB/s), rc {rc}, "
                  f"max |o - tree's o| {diff:.3e}, tickets back to 0: "
                  f"{bool((tickets == 0).all().item())}", flush=True)


# the S2 bench's shape, then two that take the kernel's two sweeps: (B, S)
S2_SHAPES = ((32, 257), (32, 300), (8, 832))


def _s1_times(smoke, args):
    """S1's variants and K3 (the bench's v0 row) at the bench's shape, M 1 and
    8, each call's tiles rotated out of the L2, beside the bound and the
    library's product on the same weights (also rotated)."""
    from teochat_torch.bench import _timing
    from teochat_torch.bench import int4_kernel as bench_int4
    from teochat_torch.ops import int4_matmul as int4_mod

    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    k, n = bench_int4.K, bench_int4.N
    w_q = torch.randint(-8, 8, (k, n), generator=gen, device="cuda").to(torch.int8)
    scale = torch.rand((n,), generator=gen, device="cuda") * 0.01
    tiles, tiles_i8 = int4_mod.pack_int4_tiled(w_q), bench_int4.pack_int4_i8(w_q)
    tiles_i4 = bench_int4.pack_int4_native(w_q)
    scale_pad = torch.nn.functional.pad(scale, (0, tiles.shape[0] * tiles.shape[2] - n))
    prepare, library = smoke.int4pack_library(tiles, scale, n,
                                              copies=-(-160 * 2**20 // tiles.numel()))
    for m in (1, 8):
        x = smoke._randn((m, k), gen)
        ops = bench_int4.byte_reuse_operands(x, k // 2)
        bound, by = smoke.bound_ms(tiles.numel() + 2 * m * k + 2 * m * n + 4 * n, 2 * m * k * n)
        rows = [
            ("S1-v3", tiles_i8, lambda t: bench_int4.v3_matmul(x, t, scale, n_out=n, operands=ops)),
            ("S1-v3 mask16", tiles_i8, lambda t: bench_int4.v3_matmul(
                x, t, scale, n_out=n, mask_dtype=torch.int16, operands=ops)),
            ("S1-v4", tiles_i4, lambda t: bench_int4.v4_matmul(x, t, scale, n_out=n)),
            ("S1-v2", tiles, lambda t: bench_int4.v2_matmul(x, t, scale, n_out=n, operands=ops)),
            ("S1-v5", tiles_i8, lambda t: bench_int4.v5_matmul(x, t, scale, n_out=n, operands=ops)),
            ("S1-dma", tiles, lambda t: bench_int4.dma_only_matmul(x, t, n_out=n)),
            ("K3 (v0)", tiles, lambda t: int4_mod.int4_matmul_tiled(x, t, scale_pad, n_out=n)),
        ]
        if m == 1:
            rows.append(("S1-vpu", tiles, lambda t: bench_int4.vpu_only(t)[0]))
            if hasattr(bench_int4, "vpu_column_sums"):  # without the total's torch sum
                rows.append(("S1-vpu kernel alone", tiles, bench_int4.vpu_column_sums))
        xp = prepare(x)
        rows.append(("torch._weight_int4pack_mm", None, lambda _: library(xp)))
        for label, t0, fn in rows:
            nxt = _timing.rotation(t0) if t0 is not None else (lambda: None)
            ms = smoke.time_ms(lambda: fn(nxt()))
            print(f"[s1s2] root={args.root} S1 K={k} N={n} M={m} {label}: {ms:.4f} ms "
                  f"({ms / bound:.2f}x the bound, {bound:.4f} ms, {by})", flush=True)


def cmd_s1s2(smoke, args):
    from teochat_torch.bench import vit_attention as bench_vit
    from teochat_torch.ops import vit_attention as vit_mod

    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    h, d = bench_vit.H, bench_vit.D
    for b, s in S2_SHAPES:
        q, k, v = (smoke._randn((b, s, h, d), gen) for _ in range(3))
        qf, kf, vf = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sweep = (1, 2, 4, 8, 16) if s == bench_vit.S else (8,)
        rows = [(f"S2-b bh={bh}", lambda bh=bh: bench_vit.call_b(q, k, v, bh=bh))
                for bh in sweep]
        rows += [("S2-c call", lambda: bench_vit.call_c(q, k, v)),
                 ("S2-c kernel alone", lambda: bench_vit.call_c_flat(qf, kf, vf)),
                 ("K5", lambda: vit_mod.vit_attention(q, k, v)),
                 ("scaled_dot_product_attention", lambda: bench_vit.call_library(q, k, v))]
        bound, by = smoke.bound_ms(*bench_vit.bound(b, s, h, d))
        for label, fn in rows:
            ms = smoke.time_ms(fn)
            print(f"[s1s2] root={args.root} [{b},{s},{h},{d}] {label}: {ms:.4f} ms "
                  f"({ms / bound:.2f}x the bound, {bound:.4f} ms, {by})", flush=True)
    _s1_times(smoke, args)
    _s1_sass(args)
    _run_phases(smoke, (("s2", smoke.phase_bench_vit), ("s1", smoke.phase_bench_int4)))


# what shows an S1 kernel's design in its SASS: the bulk copies, the tensor-core
# products, the integer-to-float conversions, the decode's integer and float work
S1_SASS_OPCODES = ("UBLKCP", "HMMA", "I2F", "I2FP", "F2F", "PRMT", "LOP3", "HADD2", "FADD",
                   "FFMA", "LDS")


def _s1_sass(args):
    """Opcode counts of each S1 kernel the tree builds (`sass_counts`: the M 1
    instantiations, and the ring body's M 8 ones where the tree keys them)."""
    from teochat_torch.bench import int4_kernel as bench_int4

    for name, ops in sorted(bench_int4.sass_counts().items()):
        counts = ", ".join(f"{op} {ops.get(op, 0)}" for op in S1_SASS_OPCODES)
        print(f"[s1s2] root={args.root} sass {name}: {sum(ops.values())} instructions: {counts}",
              flush=True)


# ------------------------------------------------------------------ s1-ring

# Reference streams over the same bytes in one launch: 16-byte loads in a
# grid-stride loop, and one thread's 1-D bulk copies into a ring of `stages`
# slots (one item a block), each consumed by a load and an xor.
_STREAM_SRC = r"""
#include <cuda_runtime.h>
#include <cstdint>
#include "hopper_async.cuh"
using namespace teochat;

__global__ void __launch_bounds__(256) ldg_stream(const uint4* __restrict__ p, long long n16,
                                                  uint32_t* out) {
  uint32_t acc = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + stride < n16; i += 2 * stride) {
    const uint4 a = __ldcs(p + i), b = __ldcs(p + i + stride);
    acc ^= a.x ^ a.y ^ a.z ^ a.w ^ b.x ^ b.y ^ b.z ^ b.w;
  }
  for (; i < n16; i += stride) { const uint4 a = p[i]; acc ^= a.x ^ a.y ^ a.z ^ a.w; }
  if (acc == 0x12345678u) out[0] = acc;
}

__global__ void __launch_bounds__(288, 1) bulk_stream(const uint8_t* base, long long item_bytes,
                                                      int stage_bytes, int stages, uint32_t* out) {
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[64];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_st = (int)(item_bytes / stage_bytes);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&bars[s]), 1);
      mbar_init(smem_u32(&bars[32 + s]), 8);
    }
    mbar_init_fence();
  }
  __syncthreads();
  uint32_t acc = 0;
  if (warp == 8) {
    for (int s = 0; lane == 0 && s < n_st; ++s) {
      const int st = s % stages;
      mbar_wait(smem_u32(&bars[32 + st]), ((s / stages) & 1) ^ 1);
      mbar_arrive_expect_tx(smem_u32(&bars[st]), stage_bytes);
      bulk_load_1d(smem_u32(smem + st * stage_bytes),
                   base + blockIdx.x * item_bytes + (long long)s * stage_bytes, stage_bytes,
                   smem_u32(&bars[st]));
    }
  } else {
    for (int s = 0; s < n_st; ++s) {
      const int st = s % stages;
      mbar_wait(smem_u32(&bars[st]), (s / stages) & 1);
      for (int o = tid * 16; o < stage_bytes; o += 256 * 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(smem + st * stage_bytes + o);
        acc ^= v.x ^ v.y ^ v.z ^ v.w;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&bars[32 + st]));
    }
  }
  if (acc == 0x12345678u) out[0] = acc;
}

extern "C" int run_ldg(const void* p, long long n16, int blocks, void* out, void* stream) {
  ldg_stream<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>((const uint4*)p, n16,
                                                                     (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int run_bulk(const void* p, int items, long long item_bytes, int stage_bytes,
                        int stages, void* out, void* stream) {
  const int smem = stages * stage_bytes;
  cudaError_t e =
      cudaFuncSetAttribute(bulk_stream, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e) return (int)e;
  bulk_stream<<<items, 288, smem, static_cast<cudaStream_t>(stream)>>>(
      (const uint8_t*)p, item_bytes, stage_bytes, stages, (uint32_t*)out);
  return (int)cudaGetLastError();
}

__global__ void empty_kernel(int x, uint32_t* out) { if (x == 12345) out[0] = 1; }
extern "C" int run_empty(int blocks, void* out, void* stream) {
  empty_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(0, (uint32_t*)out);
  return (int)cudaGetLastError();
}
"""


def _nvcc_shared(tag, sources, csrc):
    """Build `sources` ({file name: text}) beside the tree's headers into a
    shared library under the build directory; returns its path or None."""
    import shutil
    import subprocess

    from teochat_torch.ops import _build

    out = _build.BUILD_DIR / "probe" / tag
    out.mkdir(parents=True, exist_ok=True)
    for header in csrc.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    for name, text in sources.items():
        (out / name).write_text(text)
    so = out / "lib.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
                           *(str(out / name) for name in sources)],
                          capture_output=True, text=True)
    if proc.returncode:
        print(f"[s1-ring] {tag}: build failed\n{(proc.stdout + proc.stderr)[-2000:]}", flush=True)
        return None
    return so


class _BenchLibrary:
    """The S1 entries of one build of bench_int4_kernel.cu, as `_build`'s library."""

    def __init__(self, path):
        import ctypes

        from teochat_torch.ops import _build

        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in _build._SIGNATURES.items():
            if name.startswith("teochat_bench_int4_"):
                fn = getattr(self.lib, name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int

    def call(self, name, *args):
        err = getattr(self.lib, name)(*args)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")


# Edits of the ring body for the variants (text of bench_int4_kernel.cu as of
# its first ring design; a variant whose text is gone is skipped)
_RING_FMA_START = "        const uint32_t words[4] = {wv.x, wv.y, wv.z, wv.w};"
_RING_FMA_END = "    __syncwarp();\n    if (lane == 0) mbar_arrive(smem_u32(&sh.bars[RING_STAGES + st]));"
_RING_NULL = ("        acc[0][0] += __uint_as_float((wv.x ^ wv.y ^ wv.z ^ wv.w) & 0x3F7FFFFFu)"
              " + fa[0];\n      }\n    }\n")
_RING_MERGE = "  if (!split) return;\n"
_RING_STAGES = "constexpr int RING_STAGES = 4;"
_RING_M1 = "    const int m_tile_ = p.M <= 1 ? 1 : RING_M_TILE;"
_RING_M1_LABEL = "M 1 on the M > 1 kernels"


def _ring_variants(source):
    """(name, edited source) of the ring body's variants that apply to `source`."""
    out = []
    if _RING_FMA_START in source and _RING_FMA_END in source:
        a = source.index(_RING_FMA_START)
        null = source[:a] + _RING_NULL + source[source.index(_RING_FMA_END, a):]
        out.append(("consumers do one load and an xor a row", null))
        if _RING_MERGE in null:
            out.append(("consumers do one load and an xor a row, no merge",
                        null.replace(_RING_MERGE, "  return;\n")))
    if _RING_MERGE in source:
        out.append(("no merge (partials written, the launch ends)",
                    source.replace(_RING_MERGE, "  return;\n")))
    if _RING_M1 in source:
        out.append((_RING_M1_LABEL + " (v4, v5, dma on mma.sync), 8 warps",
                    source.replace(_RING_M1, "    const int m_tile_ = RING_M_TILE;")))
    if _RING_STAGES in source:
        out += [(f"ring of {n} stages", source.replace(_RING_STAGES,
                                                       f"constexpr int RING_STAGES = {n};"))
                for n in (2, 3, 6, 8)]
    return out


def cmd_s1_ring(smoke, args):
    import ctypes

    from teochat_torch.bench import _timing
    from teochat_torch.bench import int4_kernel as bench_int4
    from teochat_torch.ops import _build
    from teochat_torch.ops import int4_matmul as int4_mod

    csrc = Path(_build.CSRC)
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    k, n = bench_int4.K, bench_int4.N
    w_q = torch.randint(-8, 8, (k, n), generator=gen, device="cuda").to(torch.int8)
    scale = torch.rand((n,), generator=gen, device="cuda") * 0.01
    i8, i4 = bench_int4.pack_int4_i8(w_q), bench_int4.pack_int4_native(w_q)
    u8 = int4_mod.pack_int4_tiled(w_q)
    x = smoke._randn((1, k), gen)
    ops = bench_int4.byte_reuse_operands(x, k // 2)
    # the same bytes as 132 tiles of 344 rows: one item a tile, nothing to merge
    w_flat = torch.randint(-8, 8, (688, 132 * 512), generator=gen, device="cuda").to(torch.int8)
    i8f, i4f = bench_int4.pack_int4_i8(w_flat), bench_int4.pack_int4_native(w_flat)
    u8f = int4_mod.pack_int4_tiled(w_flat)
    scf = torch.rand((132 * 512,), generator=gen, device="cuda") * 0.01
    xf = smoke._randn((1, 688), gen)
    opsf = bench_int4.byte_reuse_operands(xf, 344)
    nbytes = i8.numel()

    def time_rows(label):
        cases = [("v3", i8, lambda t: bench_int4.v3_matmul(x, t, scale, n_out=n, operands=ops)),
                 ("v5", i8, lambda t: bench_int4.v5_matmul(x, t, scale, n_out=n, operands=ops)),
                 ("v4", i4, lambda t: bench_int4.v4_matmul(x, t, scale, n_out=n)),
                 ("dma", u8, lambda t: bench_int4.dma_only_matmul(x, t, n_out=n)),
                 ("vpu", u8, bench_int4.vpu_column_sums),
                 ("v3, 132 tiles of 344 rows, one slice", i8f,
                  lambda t: bench_int4.v3_matmul(xf, t, scf, n_out=132 * 512, operands=opsf)),
                 ("v5, 132 tiles of 344 rows, one slice", i8f,
                  lambda t: bench_int4.v5_matmul(xf, t, scf, n_out=132 * 512, operands=opsf)),
                 ("v4, 132 tiles of 344 rows, one slice", i4f,
                  lambda t: bench_int4.v4_matmul(xf, t, scf, n_out=132 * 512)),
                 ("dma, 132 tiles of 344 rows, one slice", u8f,
                  lambda t: bench_int4.dma_only_matmul(xf, t, n_out=132 * 512)),
                 ("vpu, 132 tiles of 344 rows, one slice", u8f,
                  bench_int4.vpu_column_sums)]
        for name, t0, fn in cases:
            if name.startswith("vpu") and label.startswith(_RING_M1_LABEL):
                continue  # vpu has no M > 1 kernel
            nxt = _timing.rotation(t0)
            print(f"[s1-ring] root={args.root} {label}: {name} M=1: "
                  f"{smoke.time_ms(lambda: fn(nxt())):.4f} ms", flush=True)

    # the streams: the floor of one launch that reads the bytes
    so = _nvcc_shared("streams", {"streams.cu": _STREAM_SRC}, csrc)
    if so is not None:
        lib = ctypes.CDLL(str(so))
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.run_ldg.argtypes = [P, LL, I, P, P]
        lib.run_bulk.argtypes = [P, I, LL, I, I, P, P]
        lib.run_empty.argtypes = [I, P, P]
        out = torch.zeros(4, dtype=torch.int32, device="cuda")
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        nxt = _timing.rotation(i8.view(-1))
        ms = smoke.time_ms(lambda: lib.run_ldg(nxt().data_ptr(), nbytes // 16, 132 * 4,
                                               out.data_ptr(), stream()))
        print(f"[s1-ring] stream, 16-byte loads, {nbytes} bytes: {ms:.4f} ms", flush=True)
        for stages in (2, 4, 8):
            item = nbytes // 132 // 16384 * 16384  # whole 16 KB stages, 132 items
            ms = smoke.time_ms(lambda: lib.run_bulk(nxt().data_ptr(), 132, item, 16384, stages,
                                                    out.data_ptr(), stream()))
            print(f"[s1-ring] stream, bulk copies into {stages} x 16 KB, {132 * item} bytes: "
                  f"{ms:.4f} ms", flush=True)
        ms = smoke.time_ms(lambda: lib.run_empty(132, out.data_ptr(), stream()))
        print(f"[s1-ring] an empty launch: {ms:.4f} ms", flush=True)

    # the ring body as built, then each variant built from an edited copy
    time_rows("as built")
    tree = _build.library()
    variants = _ring_variants((csrc / "bench_int4_kernel.cu").read_text())
    for i, (label, source) in enumerate(variants):
        # a directory of its own: ctypes loads a path once a process
        so = _nvcc_shared(f"ring_{i}", {"bench_int4_kernel.cu": source}, csrc)
        if so is None:
            continue
        _build._library = _BenchLibrary(so)
        try:
            time_rows(label)
        finally:
            _build._library = tree


# ------------------------------------------------------------------ profile-train


KERNEL_CLASSES = (  # (class, substrings of the kernel's name); the first match wins
    ("K4 di", ("flash_bwd_di",)),
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


# ------------------------------------------------------------------ train-step


def cmd_train_step(smoke, args):
    from teochat_torch.config import TEOChatConfig

    cfg = TEOChatConfig(quant="int8")
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    params = smoke.init_teochat(cfg, gen, "cuda", torch.bfloat16, quant="int8")
    processor = smoke.FrameProcessor(cfg.vision.image_size, smoke.SEED)
    print(f"[train-step] root={args.root}", flush=True)
    smoke.phase_train(cfg, params, smoke.WordTokenizer(), processor)


# ------------------------------------------------------------------ int8-proj

# [in, out] of a 7B layer's projections: q, k, v, o, gate, up, down
PROJ_SHAPES = [(4096, 4096)] * 4 + [(4096, 11008)] * 2 + [(11008, 4096)]


def cmd_int8_proj(smoke, args):
    from teochat_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    with torch.no_grad():
        # (a) the result's dtype
        for k, n in sorted(set(PROJ_SHAPES)) + [(4096, 32000)]:
            w = smoke._randn((k, n), gen)
            for m in (1, 8, 640, 4096):
                x = smoke._randn((m, k), gen)
                t_bf = smoke.time_ms(lambda: torch.mm(x, w))
                t_f32 = smoke.time_ms(lambda: torch.mm(x, w, out_dtype=f32))
                print(f"[int8-proj] product M={m} K={k} N={n}: bf16 result {t_bf:.4f} ms, fp32 "
                      f"result {t_f32:.4f} ms ({t_f32 / t_bf:.3f}x)", flush=True)
            del w
        # (b) one decode step's projections through the tree's wrapper
        ps = [{"kernel": torch.randint(-127, 128, s, generator=gen, device="cuda", dtype=torch.int8),
               "scale": torch.rand(s[1], generator=gen, device="cuda") * 1e-2} for s in PROJ_SHAPES]
        xs = {k: smoke._randn((1, 1, k), gen) for k in (4096, 11008)}

        def step():
            for _ in range(32):
                for p in ps:
                    quant.quantized_proj(xs[p["kernel"].shape[0]], p)

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"[int8-proj] root={args.root}: 224 quantized_proj at M=1, device drained: median "
              f"{statistics.median(times):.2f} ms, {min(times):.2f}-{max(times):.2f}", flush=True)
        # (c) the backward's operand
        m = 4096

        def dx_bf16(g, wt):
            return torch.mm(g.to(bf16), wt.to(bf16), out_dtype=f32).to(bf16)

        def dx_tree(g, wt):  # the tree's own product, whichever form it takes
            helper = getattr(quant, "mm_fp32_operand", None)
            return helper(g, wt.to(bf16), bf16) if helper else dx_bf16(g, wt)

        def dx_reduction(g, wt):
            head = g.to(bf16)
            w16 = wt.to(bf16)
            both = torch.cat([head, (g - head.float()).to(bf16)], 1)
            return torch.mm(both, torch.cat([w16, w16], 0), out_dtype=f32).to(bf16)

        def dx_addmm(g, wt):
            head = g.to(bf16)
            w16 = wt.to(bf16)
            y = torch.mm(head, w16, out_dtype=f32)
            return torch.addmm(y, (g - head.float()).to(bf16), w16, out_dtype=f32).to(bf16)

        def dx_rows(g, wt):
            head = g.to(bf16)
            both = torch.cat([head, (g - head.float()).to(bf16)])
            y = torch.mm(both, wt.to(bf16), out_dtype=f32)
            return (y[:m] + y[m:]).to(bf16)

        forms = [("bf16 operand", dx_bf16), ("the tree's", dx_tree),
                 ("head + remainder along the reduction", dx_reduction),
                 ("head + remainder in two accumulating products", dx_addmm),
                 ("head + remainder as stacked rows", dx_rows)]
        try:
            probe_g = torch.randn((8, 16), device="cuda")
            dx_addmm(probe_g, torch.ones((16, 8), device="cuda", dtype=torch.int8))
        except (RuntimeError, TypeError) as e:
            print(f"[int8-proj] two accumulating products: not offered by torch "
                  f"{torch.__version__} ({str(e).splitlines()[0][:120]})", flush=True)
            forms = [f for f in forms if f[1] is not dx_addmm]
        per_layer = {name: 0.0 for name, _ in forms}
        for p in ps:
            k, n = p["kernel"].shape
            wt = p["kernel"].t()  # [out, in], int8: every form converts it, as the port does
            g = torch.randn((m, n), generator=gen, device="cuda") * p["scale"]
            rows = slice(0, 64)  # the exact sum in fp64 on a few rows
            exact = torch.mm(g[rows].double(), wt.double()).float().to(bf16)
            for name, fn in forms:
                t = smoke.time_ms(lambda: fn(g, wt))
                per_layer[name] += t
                off = (fn(g, wt)[rows].float() != exact.float()).float().mean().item() * 256
                print(f"[int8-proj] dx M={m} N={n} K={k}, {name}: {t:.4f} ms, {off:.1f} of 256 "
                      f"a bf16 step from the exact sum's rounding", flush=True)
        for name, ms in per_layer.items():
            print(f"[int8-proj] dx, {name}: {ms:.3f} ms a layer, {ms * 64:.1f} ms an optimizer "
                  f"step (32 layers, 2 micro-steps)", flush=True)


TWO_RANK_OPS = ("collectives", "send_recv", "batch_isend_irecv", "all_to_all_single")


def _two_ranks_child(backend: str, init: str, rank: int, op: str) -> None:
    """One of two ranks on cuda:0: `op` on CUDA tensors (the mesh's
    collectives, or one point-to-point form), its values checked."""
    import datetime

    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{init}", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    x = torch.full((4,), float(rank + 1), device="cuda")
    other = 2 - rank  # the neighbour's value
    if op == "collectives":
        done = []
        for name, fn in (
                ("all_gather", lambda: dist.all_gather_into_tensor(torch.empty(8, device="cuda"),
                                                                   x)),
                ("reduce_scatter", lambda: dist.reduce_scatter_tensor(
                    torch.empty(2, device="cuda"), x)),
                ("all_reduce", lambda: dist.all_reduce(x.clone())),
                ("broadcast", lambda: dist.broadcast(x.clone(), 0))):
            fn()
            torch.cuda.synchronize()
            done.append(name)
        print(f"rank {rank} {backend}: {', '.join(done)} ran", flush=True)
    else:
        got = torch.zeros(4, device="cuda")
        if op == "send_recv":  # rank 0 sends first, rank 1 receives first
            if rank == 0:
                dist.send(x, 1)
                dist.recv(got, 1)
            else:
                dist.recv(got, 0)
                dist.send(x, 0)
        elif op == "batch_isend_irecv":
            peer = 1 - rank
            for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                                dist.P2POp(dist.irecv, got, peer)]):
                work.wait()
        else:  # a ring shift as an all-to-all: everything to the other rank
            sizes = [0, 4] if rank == 0 else [4, 0]
            dist.all_to_all_single(got, x, output_split_sizes=sizes, input_split_sizes=sizes)
        torch.cuda.synchronize()
        right = bool((got == other).all())
        print(f"rank {rank} {backend} {op}: ran, received {got.tolist()} "
              f"({'right' if right else 'WRONG'})", flush=True)
    dist.destroy_process_group()


def cmd_two_ranks(smoke, args):
    """Two processes on the one card, gloo then NCCL: which backend runs the
    collectives of the mesh (parallel/tensor_parallel.py) and which
    point-to-point forms (parallel/ring_attention.py::_rotate,
    parallel/pipeline.py) on CUDA tensors. Each (backend, operation) runs in
    its own pair of processes with 120 s; a failure prints its last error."""
    import subprocess
    import tempfile

    for backend in ("gloo", "nccl"):
        for op in TWO_RANK_OPS:
            init = tempfile.mktemp(prefix="two_ranks_")
            procs = [subprocess.Popen(
                [sys.executable, __file__, "two-ranks", "--child", backend, "--init", init,
                 "--rank", str(r), "--op", op], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True) for r in range(2)]
            for r, p in enumerate(procs):
                try:
                    out, err = p.communicate(timeout=120)
                    tail = err.strip().splitlines()[-1:] if p.returncode else []
                    print(f"[two-ranks] {backend} {op} rank {r}: exit {p.returncode} "
                          f"{out.strip()} {' '.join(tail)}", flush=True)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.communicate()
                    print(f"[two-ranks] {backend} {op} rank {r}: no answer in 120 s", flush=True)
            Path(init).unlink(missing_ok=True)


def main():
    if sys.argv[1:3] == ["two-ranks", "--child"]:  # one rank of `two-ranks`
        _two_ranks_child(sys.argv[3], sys.argv[5], int(sys.argv[7]), sys.argv[9])
        return
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in ("decode", "decode-ttft", "decode-paths", "spec", "parity", "k1", "k2m", "k4",
                 "k1k4a",
                 "k4bc", "k3k5", "k3",
                 "k5k2", "s1s2", "s1-ring", "profile-train", "train-step", "int8-proj",
                 "two-ranks"):
        p = sub.add_parser(name)
        p.add_argument("--root", type=Path, default=Path(__file__).parent)
        if name == "decode":
            p.add_argument("--reps", type=int, default=5)
            p.add_argument("--quant", nargs="+", default=["int8"], choices=["int8", "int4"])
            p.add_argument("--batches", type=int, nargs="+", default=[1, 8])
            p.add_argument("--profile", action="store_true",
                           help="also the device's kernel time a step, by kernel class")
            p.add_argument("--chunks", type=int, nargs="*", default=[],
                           help="at batch 1, also time these chunk sizes (DECODE_CHUNK)")
        if name == "k1k4a":
            p.add_argument("--tiles", nargs="+", default=["64x64", "64x128", "128x64", "128x128"])
            p.add_argument("--long", action="store_true",
                           help="also B1 S4096: many kv tiles a block, little set-up beside them")
        if name == "k4bc":
            p.add_argument("--variants", nargs="*",
                           default=["dqbk=128,stages=2", "stages=2", "stages=4"],
                           help="key=value[,key=value] over dqbk, stages")
            p.add_argument("--long", action="store_true", help="also a GQA shape and B1 S4096")
            p.add_argument("--bias", action="store_true",
                           help="also the bias branches with MPT-7B's table")
        if name == "k3":
            p.add_argument("--ms", type=int, nargs="+", default=[1, 2, 4, 8, 16, 768])
            p.add_argument("--ttft", action="store_true",
                           help="also int4 and int8 prefill + first token at batch 1")
        if name == "k2m":
            p.add_argument("--sweep", action="store_true",
                           help="also each row-group and split count through the C entry")
        if name == "k5k2":
            p.add_argument("--chunks", type=int, nargs="+", default=[32, 128],
                           help="K2 slot chunks to build the source with")
        if name == "decode-ttft":
            p.add_argument("--reps", type=int, default=9)
            p.add_argument("--quant", nargs="+", default=["int8", "int4"],
                           choices=["int8", "int4"])
        if name == "decode-paths":
            p.add_argument("--turns", type=int, default=3)
        if name == "spec":
            p.add_argument("--quant", nargs="+", default=["int8", "int4"],
                           choices=["int8", "int4"])
            p.add_argument("--batches", type=int, nargs="+", default=[1, 4])
            p.add_argument("--ks", type=int, nargs="+", default=list(range(1, 9)))
            p.add_argument("--rates", type=float, nargs="*", default=[0.75, 0.5, 0.25])
            p.add_argument("--chunks", type=int, nargs="*", default=[])
            p.add_argument("--reps", type=int, default=3)
        if name == "parity":
            p.add_argument("--seeds", type=int, nargs="+", default=[0])
            p.add_argument("--layers", type=int, nargs="+", default=[32])
            p.add_argument("--pairs", nargs="+", default=["auto:plain"])
    args = parser.parse_args()
    smoke = _import_tree(args.root)
    smoke.phase_device()
    smoke.phase_build()
    {"decode": cmd_decode, "decode-ttft": cmd_decode_ttft, "decode-paths": cmd_decode_paths,
     "spec": cmd_spec, "parity": cmd_parity, "k1": cmd_k1,
     "k2m": cmd_k2m, "k4": cmd_k4, "k1k4a": cmd_k1k4a, "k4bc": cmd_k4bc, "k3k5": cmd_k3k5, "k3": cmd_k3,
     "k5k2": cmd_k5k2,
     "s1s2": cmd_s1s2, "s1-ring": cmd_s1_ring,
     "profile-train": cmd_profile_train, "train-step": cmd_train_step,
     "int8-proj": cmd_int8_proj, "two-ranks": cmd_two_ranks}[args.cmd](smoke, args)


if __name__ == "__main__":
    main()
