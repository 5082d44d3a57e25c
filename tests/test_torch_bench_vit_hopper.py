"""The Hopper bench attention's walk against the script's Pallas kernels.

The CUDA kernel behind S2-b and S2-c (teochat_torch/csrc/bench_vit_attention.cu)
runs only on a card. Its walk is written out in plain PyTorch as
`bench.vit_attention.one_sweep_schedule`: query tiles of 64 rows, keys in
windows of 272 whose scores a tile holds whole, keys past S masked, scores in
base-2 units, one sweep up to one window and two past it, p (1 / l) rounded to
the inputs' type before P V. Here that walk is held against
scripts/bench_vit_attention.py's `call_b` (`_kernel_b`, `bh` heads a grid
cell) and `call_c` (`_kernel_c`, flat [B H, S, D] rows), loaded by path and
run in Pallas interpret mode: the script passes no `interpret` flag, so for
this file alone `pallas_call` is wrapped to add it. Nothing in `scripts/`
changes.

Same inputs from a seeded numpy generator on both sides. In fp32 the two
differ by summation order and by exp2(x log2 e) against exp(x): 1e-4
relative, with 1e-4 of the largest |output| beside it for values near 0.
Eleven JAX programs are compiled here (each shape and bh is one), well
inside what one XLA CPU process takes.
"""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from teochat_torch.bench import vit_attention as bench_vit
from teochat_torch.ops import _build
from teochat_torch.ops import vit_attention as vit_mod
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-4


@pytest.fixture(scope="module")
def script(tmp_path_factory):
    """scripts/bench_vit_attention.py, with pallas_call in interpret mode
    while this file runs."""
    patch = pytest.MonkeyPatch()
    # the script sets these at import unless they are set: keep them out of the environment
    patch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path_factory.mktemp("jax_cache")))
    patch.setenv("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "2")
    real = pl.pallas_call
    patch.setattr(pl, "pallas_call", lambda *a, **kw: real(*a, **{**kw, "interpret": True}))
    spec = importlib.util.spec_from_file_location(
        "_script_bench_vit_attention_hopper", REPO / "scripts" / "bench_vit_attention.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
        yield mod
    finally:
        patch.undo()


def _qkv(b, s, h, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, s, h, 64).astype(np.float32) for _ in range(3)]


def _script(script, name, bh, q, k, v, dtype=jnp.float32):
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    out = script.call_b(*args, bh=bh) if name == "b" else script.call_c(*args)
    return np.asarray(out.astype(jnp.float32))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("name,bh,b,s,h", [
    ("b", 1, 2, 257, 2),  # the bench's length: one window, 15 keys of it masked
    ("b", 2, 1, 9, 4),  # nine live rows of a query tile's 64, 263 of the window's keys masked
    ("b", 8, 1, 100, 8),  # ragged against the tile and the window, eight heads a cell
    ("b", 1, 1, 300, 2),  # two sweeps: a second window of 28 keys
    ("b", 2, 1, 832, 2),  # the gate: four windows, the last with 16 keys
    ("c", None, 2, 257, 2),
    ("c", None, 1, 9, 2),
    ("c", None, 1, 100, 2),
    ("c", None, 1, 300, 2),
    ("c", None, 1, 832, 1),
])
def test_schedule_matches_the_script(script, name, bh, b, s, h):
    q, k, v = _qkv(b, s, h, s)
    got = bench_vit.one_sweep_schedule(*map(torch.from_numpy, (q, k, v)))
    _close(got.numpy(), _script(script, name, bh, q, k, v))


def test_schedule_rounds_p_over_l_as_the_script_does(script):
    """In bf16 the script rounds p / l to bf16 before P V, where K5's walk
    rounds p and divides after. At S = 257 (one window) the twin lands on
    the script's bf16 outputs but where exp2 against exp or the sum's order
    moves a value across a rounding (one bf16 step of |o| < 1, 2^-8, at
    most); K5's walk, on the same inputs, is off the script at every other
    output. Read: the twin 105 of 131,584 outputs off, by 2^-10 at most;
    K5's walk 49 % off, by up to 2^-8."""
    q, k, v = _qkv(2, 257, 4, 5)
    want = _script(script, "b", 2, q, k, v, dtype=jnp.bfloat16)
    bf16 = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    got = bench_vit.one_sweep_schedule(*bf16).float().numpy()
    k5 = vit_mod.vit_attention_schedule(*bf16).float().numpy()
    assert np.abs(want).max() < 1
    assert np.abs(got - want).max() <= 2.0 ** -8
    off, k5_off = (got != want).mean(), (k5 != want).mean()
    assert off < 5e-3
    assert k5_off > 0.2


@pytest.mark.parametrize("window,tile_q", [(136, 64), (544, 64), (272, 128), (64, 16)])
def test_schedule_gives_the_same_answer_at_other_sizes(window, tile_q):
    """The window and the tile change where sums are split and whether a
    second sweep runs, not what they are: the same output as the kernel's
    sizes, at S = 300 (one window at 544, two at 272, three at 136)."""
    q, k, v = map(torch.from_numpy, _qkv(1, 300, 2, 2))
    want = bench_vit.one_sweep_schedule(q, k, v)
    got = bench_vit.one_sweep_schedule(q, k, v, window=window, tile_q=tile_q)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_schedule_takes_the_scale():
    q, k, v = map(torch.from_numpy, _qkv(1, 300, 2, 3))
    got = bench_vit.one_sweep_schedule(q, k, v, scale=0.2)
    torch.testing.assert_close(got, vit_mod.vit_attention_plain(q, k, v, scale=0.2),
                               rtol=1e-5, atol=1e-5)


def test_module_sizes_are_the_kernels():
    source = (_build.CSRC / "bench_vit_attention.cu").read_text()
    sizes = {name: int(value) for name, value in
             re.findall(r"constexpr int (TILE_Q|KEYS_A|KEYS_B|MAX_SEQ) = (\d+)", source)}
    assert sizes == {"TILE_Q": bench_vit.TILE_Q, "KEYS_A": 256, "KEYS_B": 16,
                     "MAX_SEQ": bench_vit.MAX_SEQ}
    assert sizes["KEYS_A"] + sizes["KEYS_B"] == bench_vit.WINDOW
    # both products on the tensor cores' warpgroup path, no mma.sync left
    assert "wgmma_ss" in source and "wgmma_rs_tb" in source and "mma_16816" not in source
    # every tile `wgmma` reads arrives by TMA: no thread stores to shared
    # memory (a store would need fence_proxy_async_shared before its handover)
    assert "st_shared" not in source and "st.shared" not in source
