"""The kernel benches' plain versions against the JAX scripts' Pallas kernels.

The same numpy inputs go through each function of scripts/bench_int4_kernel.py
and scripts/bench_vit_attention.py (their Pallas kernels in interpret mode) and
through the port's plain version (teochat_torch/bench/int4_kernel.py,
vit_attention.py), which is what a CPU tensor takes. The scripts pass no
`interpret` flag, so for this file alone `pallas_call` is wrapped to add it.

Tolerance: fp32 inputs, 1e-4 of the largest |reference| (both sides sum the
same products in fp32, in another order); the packers are byte-exact; the
unpack probe sums small integers and is exact. The CUDA kernels themselves
are held against these plain versions on the card (tests/test_torch_cuda.py).
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from teochat_torch.bench import int4_kernel as bench_int4
from teochat_torch.bench import vit_attention as bench_vit
from teochat_torch.ops import int4_matmul as int4_mod
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

REPO = pathlib.Path(__file__).resolve().parent.parent
K, N, M = 256, 700, 3
REL = 1e-4


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts(tmp_path_factory):
    """Both scripts, with pallas_call in interpret mode while this file runs."""
    patch = pytest.MonkeyPatch()
    # the scripts set these at import unless they are set: keep them out of the environment
    patch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path_factory.mktemp("jax_cache")))
    patch.setenv("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "2")
    real = pl.pallas_call
    patch.setattr(pl, "pallas_call", lambda *a, **kw: real(*a, **{**kw, "interpret": True}))
    try:
        yield _load("bench_int4_kernel"), _load("bench_vit_attention")
    finally:
        patch.undo()


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    w_q = rng.randint(-8, 8, size=(K, N)).astype(np.int8)
    scale = (rng.rand(N) * 0.01).astype(np.float32)
    x = rng.randn(M, K).astype(np.float32)
    return w_q, scale, x


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _torch_tiles(kind, w_q):
    w = torch.from_numpy(w_q)
    return {"u8": int4_mod.pack_int4_tiled, "i8": bench_int4.pack_int4_i8,
            "native": bench_int4.pack_int4_native}[kind](w)


@pytest.mark.parametrize("kind", ["u8", "i8", "native"])
def test_packers_are_byte_exact(scripts, data, kind):
    s1, w_q = scripts[0], data[0]
    got = _torch_tiles(kind, w_q).numpy()
    if kind == "u8":
        want = np.asarray(s1.pack_int4_tiled(jnp.asarray(w_q)))
    elif kind == "i8":
        want = np.asarray(s1.pack_int4_i8(w_q))
    else:  # the 4-bit array, two values a byte: K row 2i low, 2i + 1 high
        vals = np.asarray(s1.pack_int4_native(w_q).astype(jnp.int8))  # [n_tiles, K, bn]
        nib = (vals.astype(np.int32) & 0xF).astype(np.uint8)
        want = nib[:, 0::2] | (nib[:, 1::2] << 4)
    assert got.dtype == want.dtype and got.shape == want.shape == (2, K // 2, 512)
    assert np.array_equal(got, want)
    assert (got[1, :, N - 512:] == 0).all()  # the zero padding of the last tile


VARIANTS = {  # name -> (tiles, script call, port call)
    "v2": ("u8", lambda s, x, t, sc: s.v2_matmul(x, t, sc, n_out=N),
           lambda x, t, sc: bench_int4.v2_matmul(x, t, sc, n_out=N)),
    "v3": ("i8", lambda s, x, t, sc: s.v3_matmul(x, t, sc, n_out=N),
           lambda x, t, sc: bench_int4.v3_matmul(x, t, sc, n_out=N)),
    "v3_m16": ("i8", lambda s, x, t, sc: s.v3_matmul(x, t, sc, n_out=N, mask_dtype=jnp.int16),
               lambda x, t, sc: bench_int4.v3_matmul(x, t, sc, n_out=N, mask_dtype=torch.int16)),
    "v5": ("i8", lambda s, x, t, sc: s.v5_matmul(x, t, sc, n_out=N),
           lambda x, t, sc: bench_int4.v5_matmul(x, t, sc, n_out=N)),
    "v4": ("native", lambda s, x, t, sc: s.v4_matmul(x, t, sc, n_out=N),
           lambda x, t, sc: bench_int4.v4_matmul(x, t, sc, n_out=N)),
    "dma": ("u8", lambda s, x, t, sc: s.dma_only_matmul(x, t, n_out=N),
            lambda x, t, sc: bench_int4.dma_only_matmul(x, t, n_out=N)),
}


def _script_tiles(s1, kind, w_q):
    if kind == "u8":
        return s1.pack_int4_tiled(jnp.asarray(w_q))
    return s1.pack_int4_i8(w_q) if kind == "i8" else s1.pack_int4_native(w_q)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_int4_variant_matches_the_script(scripts, data, name):
    s1, (w_q, scale, x) = scripts[0], data
    kind, script_call, port_call = VARIANTS[name]
    scale_pad = np.pad(scale, (0, 1024 - N))
    want = script_call(s1, jnp.asarray(x), _script_tiles(s1, kind, w_q), jnp.asarray(scale_pad))
    got = port_call(torch.from_numpy(x), _torch_tiles(kind, w_q), torch.from_numpy(scale_pad))
    assert got.dtype == torch.float32 and _rel(got.numpy(), want) <= REL
    if name != "dma":  # and both are the exact product, to the same tolerance
        exact = x.astype(np.float64) @ w_q.astype(np.float64) * scale
        assert _rel(got.numpy(), exact) <= REL
        # the true-width scale is taken as well as the padded one
        same = port_call(torch.from_numpy(x), _torch_tiles(kind, w_q), torch.from_numpy(scale))
        assert torch.equal(same, got)


def test_byte_reuse_rounds_its_operands_as_the_script_does(scripts, data):
    """In bf16 the wrapper rounds xa and xb to bf16 on both sides: the outputs
    agree to the bf16 rounding of the result (2^-8 of an element)."""
    s1, (w_q, scale, x) = scripts[0], data
    scale_pad = np.pad(scale, (0, 1024 - N))
    want = s1.v3_matmul(jnp.asarray(x, jnp.bfloat16), s1.pack_int4_i8(w_q),
                        jnp.asarray(scale_pad), n_out=N)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = bench_int4.v3_matmul(xb, _torch_tiles("i8", w_q), torch.from_numpy(scale_pad), n_out=N)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= 2 ** -7
    xa, xb2 = bench_int4.byte_reuse_operands(xb, K // 2)
    assert xa.dtype == xb2.dtype == torch.bfloat16 and xa.shape == (M, K // 2)
    assert torch.equal(xb2.float() * 16, xb[:, K // 2:].float())  # a division by 16 is exact


def test_vpu_probe_matches_the_script(scripts, data):
    s1, w_q = scripts[0], data[0]
    want = float(s1.vpu_only(s1.pack_int4_tiled(jnp.asarray(w_q))))
    cols, total = bench_int4.vpu_only(_torch_tiles("u8", w_q))
    assert cols.shape == (2, 512) and cols.dtype == torch.float32
    # the script repeats each column sum over 8 sublanes; padded columns decode to (-8, -8)
    assert 8 * total.item() == want == 8 * (int(w_q.sum()) - 16 * (K // 2) * (1024 - N))
    assert torch.equal(cols.reshape(-1)[:N], torch.from_numpy(w_q.astype(np.float32).sum(0)))


@pytest.mark.parametrize("name", ["b", "c"])
def test_vit_variant_matches_the_script(scripts, name):
    s2 = scripts[1]
    rs = np.random.RandomState(0)
    q, k, v = (rs.randn(2, 37, 8, 64).astype(np.float32) for _ in range(3))
    want = getattr(s2, f"call_{name}")(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = getattr(bench_vit, f"call_{name}")(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got.shape == (2, 37, 8, 64) and _rel(got.numpy(), want) <= REL
    assert _rel(bench_vit.call_library(*(torch.from_numpy(a) for a in (q, k, v))).numpy(),
                want) <= REL  # the library row computes the same function


def test_native_unpack_round_trip(data):
    w_q = data[0]
    tiles = bench_int4.pack_int4_native(torch.from_numpy(w_q))
    back = bench_int4.unpack_int4_native(tiles, torch.int8)
    assert torch.equal(back[:, :N], torch.from_numpy(w_q)) and (back[:, N:] == 0).all()
    with pytest.raises(ValueError):
        bench_int4.pack_int4_native(torch.zeros((3, 8), dtype=torch.int8))  # odd fan-in


def test_wrappers_refuse_what_they_do_not_take(data):
    w_q, scale, x = data
    xt, sc = torch.from_numpy(x), torch.from_numpy(scale)
    with pytest.raises(ValueError, match="mask_dtype"):
        bench_int4.v3_matmul(xt, _torch_tiles("i8", w_q), sc, n_out=N, mask_dtype=torch.int8)
    with pytest.raises(ValueError, match="no kernel for device"):
        bench_int4.v2_matmul(xt.to("meta"), _torch_tiles("u8", w_q), sc, n_out=N)
    q = torch.zeros((1, 8, 4, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        bench_vit.call_b(q, q, q)
    assert bench_vit.bound(32, 257, 16, 64) == (67_371_008, 4 * 32 * 16 * 257 * 257 * 64)
    assert set(bench_int4.COUNTERS) == {"S1-v2", "S1-v3", "S1-v4", "S1-v5", "S1-vpu", "S1-dma"}
    assert all(c.count == 0 for c in bench_int4.COUNTERS.values())  # the CPU launches nothing
