"""The port's main bench (teochat_torch/bench/main.py) on the CPU.

Its arithmetic (`_roofline_keys`, `_train_mfu`) is held against bench.py's on
the same numbers, exactly, and so are the speculative phase's workloads and
tokenizer and the eval phase's tokenizer; each ported phase (the serving
engine's, eval's and the preprocessing ones among them) runs at a tiny
configuration on "cpu" and
returns the keys its JAX twin returns (the times are the host's here and say
nothing of a card); no phase is left unported; the shared timing helper's
bound arithmetic is checked.
"""

import dataclasses
import importlib.util
import math
import pathlib

import pytest
import torch

from teochat_tpu.config import TEOChatConfig as JaxTEOChatConfig
from teochat_torch.bench import _timing
from teochat_torch.bench import main as bench_main
from teochat_torch.config import TEOChatConfig, tiny_test_config

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_bench(tmp_path_factory):
    """bench.py loaded by path; the cache settings it would leave in the
    environment at import are set here instead and taken back afterwards."""
    patch = pytest.MonkeyPatch()
    patch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path_factory.mktemp("jax_cache")))
    patch.setenv("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "2")
    spec = importlib.util.spec_from_file_location("_jax_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
        yield mod
    finally:
        patch.undo()


@pytest.fixture(scope="module")
def tiny():
    """2 frames of 4 tokens and 23 text tokens in a 32-token prompt, 4 new tokens."""
    cfg = dataclasses.replace(tiny_test_config(), dtype="float32")
    return bench_main.Settings(
        cfg=cfg, device="cpu", prompt_len=32, text_tokens=20, decode_new=4, e2e_new=3,
        enc_batch=2, enc_iters=1, train_batch=2, iters=1, stream_side=64, stream_panels=2,
        stream_reps=2, matmul_side=32, train_bf16_llm={})


@pytest.fixture(scope="module")
def tiny_serve():
    """The serving phases at a tiny size: 4 streams of 13 text tokens and 4
    new ones; prefixes of 16 (ttft_prefix), 12 and 20 tokens, pooled from 8,
    in a vocabulary that holds bench.py's ids (up to 7,000 + the prefix)."""
    cfg = dataclasses.replace(tiny_test_config(vocab_size=8192), dtype="float32")
    return bench_main.Settings(
        cfg=cfg, device="cpu", serve_requests=4, serve_text=12, serve_new=4, serve_max_len=64,
        serve_chunk=2, prefix_len=16, prefix_max_len=64, prefix_min_tokens=8,
        prefix_curve=((12, 48), (20, 64)))


@pytest.fixture(scope="module")
def tiny_eval():
    """eval, preprocess and encode_pipeline at a tiny size: 4 examples of two
    40 x 52 frames in batches of 2 and 1, 3 new tokens; 4 frames to
    preprocess; 2 batches of 2 frames through the tower."""
    cfg = dataclasses.replace(tiny_test_config(vocab_size=256), dtype="float32")
    return bench_main.Settings(
        cfg=cfg, device="cpu", frame_hw=(40, 52), eval_examples=4, eval_batch=2, eval_new=3,
        preprocess_n=4, pipeline_batches=2, enc_batch=2)


@pytest.fixture(scope="module")
def tiny_spec():
    """The tiny model with a vocabulary that holds the workloads' ids (up to
    171), 16 new tokens, 2 drafts; ttft_turn2's suffix of 8 over the
    32-token prompt, padded to 16, in a 64-slot cache."""
    cfg = dataclasses.replace(tiny_test_config(vocab_size=256), dtype="float32")
    return bench_main.Settings(
        cfg=cfg, device="cpu", prompt_len=32, text_tokens=20, decode_new=16, spec_k=2,
        turn2_suffix=8, turn2_pad=16, turn2_max_len=64, iters=1)


@pytest.mark.parametrize("args", [
    (98.0, 6_600_000_000, 3.7e8, 650.0, ""),
    (42.9, 3_500_000_000, 3.6e8, 2900.0, "_int4"),
    (10.0, 1, 0.0, 0.0, ""),  # no peak: the share is None
])
def test_roofline_keys_same_arithmetic(jax_bench, args):
    assert bench_main._roofline_keys(*args) == jax_bench._roofline_keys(*args)


@pytest.mark.parametrize("full", [False, True])
def test_train_mfu_same_arithmetic(jax_bench, full):
    ours, theirs = TEOChatConfig().llm, JaxTEOChatConfig().llm
    assert bench_main._llm_matmul_params(ours) == jax_bench._llm_matmul_params(theirs)
    got = bench_main._train_mfu(ours, 2400.0, 640, 700.0, full_finetune=full)
    assert got == jax_bench._train_mfu(theirs, 2400.0, 640, 700.0, full_finetune=full)
    assert 0 < got < 1


PHASE_KEYS = {
    "encode": {"encode_s_per_batch", "encode_frames_per_sec"},
    "encode_w8a8": {"encode_s_per_batch_w8a8", "encode_frames_per_sec_w8a8"},
    "ttft_int8act": {"ttft_s_prefill640_int8act"},
    "decode": {"decode_tokens_per_sec", "decode_tokens_per_sec_min", "decode_tokens_per_sec_max",
               "ttft_s_prefill640_int8", "full_loop_s", "prefill_tokens", "hbm_stream_peak_gbps",
               "decode_effective_hbm_gbps", "decode_pct_of_hbm_peak"},
    "decode_bs8": {"decode_tokens_per_sec_bs8"},
    "decode_bs16": {"decode_tokens_per_sec_bs16"},
    "decode_bs32": {"decode_tokens_per_sec_bs32_fp8kv"},
    "decode_int4": {"decode_tokens_per_sec_int4", "decode_effective_hbm_gbps_int4",
                    "decode_pct_of_hbm_peak_int4", "decode_tokens_per_sec_int4_fp8kv"},
    "e2e": {"xbd_2frame_e2e_latency_s_32newtok"},
    # bench.py's keys carry its sizes (8 streams, 64 tokens, a 512 + 3 token
    # prompt, prefixes 128 / 1024 / 2048); these carry tiny_serve's
    "serve": {"serve_aggregate_tokens_per_sec_4streams", "serve_4x4tok_wall_s",
              "serve_max_concurrent"},
    "ttft_prefix": {"ttft_s_prefix_miss_19tok", "ttft_s_prefix_hit_19tok",
                    "prefix_hit_ttft_speedup", "prefix_tokens_saved"},
    "ttft_prefix_curve": {f"{key}_{plen}{unit}" for plen in (12, 20) for key, unit in (
        ("ttft_s_prefix_miss", "tok"), ("ttft_s_prefix_hit", "tok"),
        ("prefix_hit_ttft_speedup", ""))},
    "train": {"train_step_s_bs2_seq32", "train_tokens_per_sec", "tensor_core_peak_tflops",
              "train_mfu", "train_tokens_per_sec_accum8", "train_mfu_accum8"},
    # bench.py's names: its 1.1B geometry, here the tiny decoder's
    "train_bf16": {"train_tokens_per_sec_bf16full_1b", "train_mfu_bf16full_1b"},
    # bench.py's eval keys carry its batch of 8; these tiny_eval's batch of 2
    "eval": {"eval_examples_per_sec_bs2", "eval_examples_per_sec_bs1", "eval_bs2_vs_bs1"},
    "preprocess": {"preprocess_pil_frames_per_sec", "preprocess_native_frames_per_sec"},
    # the bf16 tower's keys, and the w8a8 tower's ending _w8a8
    "encode_pipeline": {"h2d_mbps"} | {
        k + suffix for k in ("encode_sustained_fps_hostpre", "encode_sustained_fps_devicepre",
                             "encode_frames_per_sec_deviceonly",
                             "encode_sustained_vs_deviceonly")
        for suffix in ("", "_w8a8")},
}


@pytest.mark.parametrize("name", list(PHASE_KEYS))
def test_phase_returns_its_keys_at_a_tiny_config(tiny, tiny_serve, tiny_eval, name):
    if name in ("serve", "ttft_prefix", "ttft_prefix_curve"):
        st = tiny_serve
    elif name in ("eval", "preprocess", "encode_pipeline"):
        st = tiny_eval
    else:
        st = tiny
    out = bench_main.run_phase(name, st)
    assert set(out) == PHASE_KEYS[name]
    assert all(isinstance(v, (int, float)) and math.isfinite(v) and v > 0 for v in out.values())
    if name == "serve":
        assert out["serve_max_concurrent"] >= 2
    if name == "ttft_prefix":  # 3 hits of the 16-token prefix after the one that warms
        assert out["prefix_tokens_saved"] == 4 * 16
    if name == "decode":
        assert out["prefill_tokens"] == 32
        assert out["decode_tokens_per_sec_min"] <= out["decode_tokens_per_sec"] \
            <= out["decode_tokens_per_sec_max"]


SPEC_PHASE_KEYS = {
    "decode_spec": {
        "decode_tokens_per_sec_spec_bs1", "spec_iteration_s", "spec_steps_for_16_tokens",
        "spec_mean_tokens_per_step",
        *(f"{key}_{w}" for w in ("detection", "regionqa") for key in (
            "decode_tokens_per_sec_spec", "spec_acceptance", "spec_tokens_per_step")),
        *(f"{key}{pct}" for pct in (75, 50, 25) for key in (
            "decode_tokens_per_sec_spec_bs1_acc", "spec_tokens_per_step_acc"))},
    "ttft_turn2": {"ttft_s_turn2_suffix8_over32"},
}


@pytest.mark.parametrize("name", list(SPEC_PHASE_KEYS))
def test_spec_phases_return_their_keys_at_a_tiny_config(tiny_spec, name):
    """decode_spec and ttft_turn2 under bench.py's keys (the step count's and
    the turn's key carry this configuration's sizes, as bench.py's carry
    its own: `spec_steps_for_64_tokens`, `ttft_s_turn2_suffix64_over640`)."""
    out = bench_main.run_phase(name, tiny_spec)
    assert set(out) == SPEC_PHASE_KEYS[name]
    assert all(isinstance(v, (int, float)) and math.isfinite(v) and v >= 0
               for v in out.values())
    if name == "decode_spec":  # the acceptances are rates; at random weights they may be 0
        assert all(0 <= out[f"spec_acceptance_{w}"] <= 1 for w in ("detection", "regionqa"))
        assert 1 <= out["spec_tokens_per_step_regionqa"] <= 1 + tiny_spec.spec_k
        assert out["spec_steps_for_16_tokens"] <= 16
    assert all(v > 0 for key, v in out.items() if "per_sec" in key or key.startswith("ttft"))


def test_spec_workloads_and_tokenizer_are_bench_pys(jax_bench):
    assert bench_main._SPEC_WORKLOADS == jax_bench._SPEC_WORKLOADS
    ours, theirs = {}, {}
    for prompt, answer in bench_main._SPEC_WORKLOADS.values():
        for text in (prompt, answer):
            assert bench_main._eo_tokenize(text, ours) == jax_bench._eo_tokenize(text, theirs)
    assert ours == theirs and max(ours.values()) < 256


def test_eval_tokenizer_is_bench_pys(jax_bench):
    ours, theirs = bench_main._BenchTokenizer(), jax_bench._BenchTokenizer()
    text = "A chat between a curious human <image> and an assistant. [301, 283, 338, 308]?"
    for line in (text, text.upper(), text):
        assert ours(line).input_ids == theirs(line).input_ids
    ids = ours(text).input_ids
    assert ours.decode(ids) == theirs.decode(ids)
    assert ours.batch_decode([ids, ids[:3]]) == theirs.batch_decode([ids, ids[:3]])


def test_default_settings_give_bench_pys_keys():
    st = bench_main.Settings(device="cpu")
    assert (st.decode_new, st.spec_k, st.prompt_len, st.turn2_suffix) == (64, 8, 640, 64)
    assert (st.turn2_pad, st.turn2_max_len, st.text_tokens) == (128, 1024, 123)
    assert (st.serve_requests, st.serve_text, st.serve_new, st.serve_max_len,
            st.serve_chunk) == (8, 120, 64, 512, 16)
    assert (st.prefix_len, st.prefix_max_len, st.prefix_min_tokens) == (512, 1024, 32)
    assert st.prefix_curve == ((128, 512), (1024, 2048), (2048, 2560))
    assert (st.frame_hw, st.eval_examples, st.eval_batch, st.eval_new) == ((512, 640), 16, 8, 16)
    assert (st.preprocess_n, st.pipeline_batches, st.enc_batch) == (64, 8, 32)
    assert st.train_bf16_llm == dict(hidden_size=2048, intermediate_size=5632, num_layers=22,
                                     num_heads=32, num_kv_heads=4)  # bench.py's phase_train_bf16


def test_every_ported_phase_is_listed():
    assert set(PHASE_KEYS) | set(SPEC_PHASE_KEYS) == set(bench_main.PHASES)


def test_unknown_phase_and_missing_card():
    with pytest.raises(ValueError, match="unknown bench phase"):
        bench_main.run_phase("decode_bs7", bench_main.Settings(device="cpu"))
    if torch.cuda.is_available():
        pytest.skip("with a card the bench would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_main.main(["--phases", "encode"])


def test_decode_setup_counts_the_bytes_a_step_reads(tiny):
    run_generate, max_new, prompt_len = bench_main.build_decode_setup(tiny, batch=2, quant="int8")
    llm = tiny.cfg.llm
    toks = run_generate(max_new)
    assert toks.shape == (2, 4) and (max_new, prompt_len) == (4, 32)
    # 31 live prompt tokens a row, and on average 1.5 decoded ones over the 3 timed steps
    live = 2 * 31 + 2 * 1.5
    assert run_generate.kv_bytes == 2 * llm.num_layers * live * llm.num_kv_heads * llm.head_dim * 4
    int8 = llm.num_layers * (4 * 64 * 64 + 3 * 64 * 128) + 128 * 64
    assert int8 < run_generate.weight_bytes < int8 + 4 * (128 * 64 + 40 * 128)


def test_bound_and_rotation_helpers():
    assert _timing.bound_ms(3.35e9, 0) == (1.0, "bytes")
    ms, by = _timing.bound_ms(1.0, 989e9)
    assert by == "operations" and ms == pytest.approx(1.0)
    row = _timing.kernel_row(1e-3, 0.5, 2.0, 3.35e9, 0, library_ms=None)
    assert row == {"max_abs_err": 1e-3, "ms": 0.5, "plain_ms": 2.0, "bound_ms": 1.0,
                   "bound_by": "bytes", "library_ms": None}
    t = torch.arange(6).reshape(2, 3)
    nxt = _timing.rotation(t, total_bytes=4 * t.numel() * t.element_size())
    seen = {nxt().data_ptr() for _ in range(8)}
    assert len(seen) == 4 and all(torch.equal(nxt(), t) for _ in range(4))
    times = _timing.timeit_all(lambda: None, iters=2, device="cpu")
    assert len(times) == 3 and times == sorted(times)
