"""The port's main bench (teochat_torch/bench/main.py) on the CPU.

Its arithmetic (`_roofline_keys`, `_train_mfu`) is held against bench.py's on
the same numbers, exactly; each ported phase runs at a tiny configuration on
"cpu" and returns the keys its JAX twin returns (the times are the host's
here and say nothing of a card); an unported phase raises and names its
ROADMAP item; the shared timing helper's bound arithmetic is checked.
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
        stream_reps=2, matmul_side=32)


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
    "decode": {"decode_tokens_per_sec", "decode_tokens_per_sec_min", "decode_tokens_per_sec_max",
               "ttft_s_prefill640_int8", "full_loop_s", "prefill_tokens", "hbm_stream_peak_gbps",
               "decode_effective_hbm_gbps", "decode_pct_of_hbm_peak"},
    "decode_bs8": {"decode_tokens_per_sec_bs8"},
    "decode_bs16": {"decode_tokens_per_sec_bs16"},
    "decode_int4": {"decode_tokens_per_sec_int4", "decode_effective_hbm_gbps_int4",
                    "decode_pct_of_hbm_peak_int4"},
    "e2e": {"xbd_2frame_e2e_latency_s_32newtok"},
    "train": {"train_step_s_bs2_seq32", "train_tokens_per_sec", "tensor_core_peak_tflops",
              "train_mfu"},
}


@pytest.mark.parametrize("name", list(PHASE_KEYS))
def test_phase_returns_its_keys_at_a_tiny_config(tiny, name):
    out = bench_main.run_phase(name, tiny)
    assert set(out) == PHASE_KEYS[name]
    assert all(isinstance(v, (int, float)) and math.isfinite(v) and v > 0 for v in out.values())
    if name == "decode":
        assert out["prefill_tokens"] == 32
        assert out["decode_tokens_per_sec_min"] <= out["decode_tokens_per_sec"] \
            <= out["decode_tokens_per_sec_max"]


def test_every_ported_phase_is_listed():
    assert set(PHASE_KEYS) == set(bench_main.PHASES)
    assert not set(bench_main.PHASES) & set(bench_main.UNPORTED)


@pytest.mark.parametrize("name", sorted(bench_main.UNPORTED))
def test_unported_phase_raises_and_names_its_item(tiny, name):
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md queue 1"):
        bench_main.run_phase(name, tiny)


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
