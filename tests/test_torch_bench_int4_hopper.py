"""The int4 bench's ring body (S1-v3, S1-v4) against the script's Pallas kernels.

The ring kernels of teochat_torch/csrc/bench_int4_kernel.cu run only on a
card. Their walk is written out in plain PyTorch as
`bench/int4_kernel.py::ring_schedule`: items of (tile, K slice) for each
chunk of 8 rows of x, K cut into the slices that `ring_k_slices` picks for
an H100 SXM's 132 SMs (or a given count), each slice walked in stages of
RING_STAGE_BYTES // tw byte rows, an fp32 partial an item, a tile's partials
summed in slice order, then v3's correction, the scale and one rounding.
Here that walk is held against scripts/bench_int4_kernel.py's `v3_matmul`
(mask at 32 and 16 bits) and `v4_matmul`, their Pallas kernels in interpret
mode (the script passes no `interpret` flag, so for this file alone
`pallas_call` is wrapped to add it), against the port's plain versions at
more shapes, and the split rule and the module's sizes against the `.cu`.

Same seeded numpy inputs on both sides, fp32. Tolerance: 1e-4 of the
largest |reference|, as in tests/test_torch_bench_kernels.py (both sides sum
the same exact products in fp32, in other orders; v3's terms reach 16 times
the result before the correction cancels them). Each JAX shape is one more
XLA compilation in the worker's process, so the JAX cases are few.
"""

import importlib.util
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from teochat_torch.bench import int4_kernel as bench_int4
from teochat_torch.ops import _build

REPO = pathlib.Path(__file__).resolve().parent.parent
REL = 1e-4


@pytest.fixture(scope="module")
def script(tmp_path_factory):
    """scripts/bench_int4_kernel.py, with pallas_call in interpret mode while this file runs."""
    patch = pytest.MonkeyPatch()
    # the script sets these at import unless they are set: keep them out of the environment
    patch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path_factory.mktemp("jax_cache")))
    patch.setenv("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "2")
    real = pl.pallas_call
    patch.setattr(pl, "pallas_call", lambda *a, **kw: real(*a, **{**kw, "interpret": True}))
    try:
        spec = importlib.util.spec_from_file_location(
            "_script_bench_int4_kernel_ring", REPO / "scripts" / "bench_int4_kernel.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        yield mod
    finally:
        patch.undo()


def _inputs(k, n, m, seed=0):
    rng = np.random.RandomState(seed)
    w_q = rng.randint(-8, 8, size=(k, n)).astype(np.int8)
    scale = (rng.rand(n) * 0.01).astype(np.float32)
    x = rng.randn(m, k).astype(np.float32)
    return w_q, scale, x


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _walk(variant, x, w_q, scale, n, tw, k_slices, sms=bench_int4.H100_SXM_SMS):
    pack = bench_int4.pack_int4_native if variant == "v4" else bench_int4.pack_int4_i8
    tiles = pack(torch.from_numpy(w_q), tw)
    return bench_int4.ring_schedule(
        torch.from_numpy(x), tiles, torch.from_numpy(scale), n_out=n, native=variant == "v4",
        k_slices=k_slices, sms=sms)


# (variant, K, N, M, tile width, K slices or None for the rule's)
JAX_CASES = [
    # k2 200, not a multiple of the 32 rows of a stage; slices 72, 72, 56; N < 2 tiles
    ("v3", 400, 700, 3, 512, 3),
    # tiles of 128 (stages of 128 rows), the rule's 16 slices of 8 rows, M 1
    ("v3_m16", 256, 300, 1, 128, None),
    # one tile of 1024 (stages of 16 rows) wider than N, ragged slices, M 8
    ("v4", 400, 700, 8, 1024, 3),
    # M 11: two chunks of 8 rows; the rule's 17 slices of 8 rows
    ("v4", 272, 700, 11, 512, None),
    # tiles of 128, M 1, slices 56 x 4 and 32
    ("v4", 512, 300, 1, 128, 5),
]


@pytest.mark.parametrize("variant,k,n,m,tw,k_slices", JAX_CASES)
def test_walk_matches_the_script(script, variant, k, n, m, tw, k_slices):
    w_q, scale, x = _inputs(k, n, m)
    n_pad = -(-n // tw) * tw
    scale_pad = jnp.asarray(np.pad(scale, (0, n_pad - n)))
    if variant == "v4":
        want = script.v4_matmul(jnp.asarray(x), script.pack_int4_native(w_q, tw), scale_pad,
                                n_out=n)
    else:
        mask = jnp.int16 if variant == "v3_m16" else jnp.int32
        want = script.v3_matmul(jnp.asarray(x), script.pack_int4_i8(w_q, tw), scale_pad,
                                n_out=n, mask_dtype=mask)
    got = _walk(variant[:2], x, w_q, scale, n, tw, k_slices)
    assert got.dtype == torch.float32 and _rel(got.numpy(), want) <= REL
    exact = x.astype(np.float64) @ w_q.astype(np.float64) * scale
    assert _rel(got.numpy(), exact) <= REL


@pytest.mark.parametrize("variant", ["v3", "v4"])
@pytest.mark.parametrize("k,n,m,tw,k_slices", [
    (4096, 11008, 1, 512, None),  # the bench's projection: 22 tiles x 6 slices
    (4096, 11008, 8, 1024, None),  # 11 x 12
    (1024, 3000, 19, 2048, None),  # three chunks of 8 rows, stages of 8 rows
    (1024, 1000, 3, 384, 7),  # a width no power of two: 40 rows a stage
    (64, 520, 2, 128, 1),  # one slice, one stage
])
def test_walk_matches_the_plain_versions(variant, k, n, m, tw, k_slices):
    w_q, scale, x = _inputs(k, n, m, seed=1)
    got = _walk(variant, x, w_q, scale, n, tw, k_slices)
    pack, plain = ((bench_int4.pack_int4_native, bench_int4.v4_matmul_plain) if variant == "v4"
                   else (bench_int4.pack_int4_i8, bench_int4.v3_matmul_plain))
    want = plain(torch.from_numpy(x), pack(torch.from_numpy(w_q), tw),
                 torch.from_numpy(scale), n_out=n)
    assert _rel(got.numpy(), want.numpy()) <= REL


def test_walk_rounds_once_in_bf16():
    """bf16 x: v4's walk divides x's odd rows by 16 (exact) and rounds once,
    so it lies within one bf16 step of the plain version's rounding."""
    w_q, scale, x = _inputs(512, 700, 3, seed=2)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    tiles = bench_int4.pack_int4_native(torch.from_numpy(w_q))
    got = bench_int4.ring_schedule(xb, tiles, torch.from_numpy(scale), n_out=700, native=True)
    want = bench_int4.v4_matmul_plain(xb, tiles, torch.from_numpy(scale), n_out=700)
    assert got.dtype == torch.bfloat16
    step = want.float().abs() * 2.0 ** -7
    assert ((got.float() - want.float()).abs() <= step).all()


@pytest.mark.parametrize("n_tiles,k2,sms,want", [
    (22, 2048, 132, 6),  # tw 512: 132 items
    (11, 2048, 132, 12),  # tw 1024: 132
    (6, 2048, 132, 22),  # tw 2048: 132
    (22, 2048, 114, 5),  # an H100 PCIe: 110 of 114
    (22, 2048, 78, 3),  # 66 of 78
    (1, 8, 132, 1),  # tiny k2: one slice of 8 rows
    (1, 48, 132, 6),  # slices of 8 rows at most
    (200, 8192, 132, 4),  # more tiles than SMs, but x's slice must fit
])
def test_split_rule_picks(n_tiles, k2, sms, want):
    k_slices = bench_int4.ring_k_slices(n_tiles, k2, sms)
    assert k_slices == want
    rows = bench_int4.ring_slice_rows(k2, k_slices)
    assert rows % bench_int4.RING_ALIGN == 0 and -(-k2 // rows) == k_slices
    assert rows <= bench_int4.RING_MAX_SLICE_ROWS
    if n_tiles * -(-k2 // bench_int4.RING_MAX_SLICE_ROWS) <= sms:  # no more than a wave
        assert n_tiles * k_slices <= sms


def test_walk_refuses_a_cut_the_kernels_refuse():
    w_q, scale, x = _inputs(96, 300, 8)
    with pytest.raises(ValueError, match="k_slices"):  # 48 rows in 5: the last slice empty
        _walk("v3", x, w_q, scale, 300, 512, 5)
    with pytest.raises(ValueError, match="k_slices"):
        _walk("v4", x, w_q, scale, 300, 512, 0)
    w_q, scale, x = _inputs(8192, 128, 8)  # one slice of 4096 rows: x's 128 KB at M 8
    with pytest.raises(ValueError, match="fits at M 8"):
        _walk("v4", x, w_q, scale, 128, 128, 1)
    got = _walk("v4", x[:1], w_q, scale, 128, 128, 1)  # at M 1 it fits
    assert _rel(got.numpy(), x[:1].astype(np.float64) @ w_q * scale) <= REL


def test_module_sizes_are_the_kernels():
    source = (pathlib.Path(_build.CSRC) / "bench_int4_kernel.cu").read_text()
    sizes = {name: eval(value, {}) for name, value in  # noqa: S307 (integer products)
             re.findall(r"constexpr int RING_(\w+) = ([0-9 *]+);", source)}
    assert sizes == {"STAGES": bench_int4.RING_STAGES,
                     "STAGE_BYTES": bench_int4.RING_STAGE_BYTES,
                     "WARPS": bench_int4.RING_WARPS, "WARPS_M1": bench_int4.RING_WARPS_M1,
                     "ALIGN": bench_int4.RING_ALIGN,
                     "X_BYTES": bench_int4.RING_X_BYTES, "M_TILE": bench_int4.RING_M_TILE,
                     "MAX_TW": bench_int4.RING_MAX_TW}
    # the ring stays within an SM, and its sizes are constants, not build switches
    assert "RING_BYTES + RING_X_BYTES + 10 * 1024 <= 227 * 1024" in source
    assert bench_int4.RING_STAGES * bench_int4.RING_STAGE_BYTES >= 64 * 1024  # in flight
    assert "#ifndef" not in source and "getenv" not in source
    # v3 and v4 launch the ring kernels, streamed by bulk copies; v4 converts no integer
    # and takes M > 1 on mma.sync
    body = source[source.index("void ring_body("):source.index("int ring_slice_rows(")]
    assert "MMA = NATIVE && MT > 1" in body and "ring_consume_mma<W>(" in body
    assert [n // 8 * 8 for n in (42, 32, 16, 8)] == [
        bench_int4.ring_stage_rows(tw) for tw in (384, 512, 1024, 2048)]
    # one integer ticket a block, no float atomics
    assert "bulk_load_1d" in body and body.count("atom.acq_rel.gpu.global.add.s32") == 1
    assert "atomicAdd(" not in body and "red." not in body
    assert "__int2float" not in source and "bfe" not in source
    for entry, kernel in (("teochat_bench_int4_v3", "bench_int4_v3_ring_kernel"),
                          ("teochat_bench_int4_v4", "bench_int4_v4_ring_kernel")):
        launch = source[source.index(f'"C" int {entry}('):]
        assert f"RING_LAUNCH({kernel})" in launch[:launch.index("\n}\n")]
    header = (pathlib.Path(_build.CSRC) / "hopper_async.cuh").read_text()
    assert "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1]" \
        in header


def test_sass_names_are_found():
    """`sass_counts` keys each kernel's M = 1 instantiation by its variant."""
    names = {
        "_ZN12_GLOBAL__N_120bench_int4_v2_kernelILi32ELi1EEEvNS_4ArgsE": "v2",
        "_ZN12_GLOBAL__N_125bench_int4_v3_ring_kernelILi1EEEvNS_8RingArgsE": "v3_ring",
        "_ZN12_GLOBAL__N_125bench_int4_v4_ring_kernelILi1EEEvNS_8RingArgsE": "v4_ring",
        "_ZN12_GLOBAL__N_125bench_int4_v4_ring_kernelILi8EEEvNS_8RingArgsE": None,
        "_ZN12_GLOBAL__N_121bench_int4_dma_kernelILi128ELi1EEEvNS_4ArgsE": None,
    }
    for name, key in names.items():
        found = bench_int4.SASS_KERNEL.match(name)
        assert (found.group(1) if found else None) == key


def test_cpu_wrappers_take_the_plain_versions():
    """On the CPU the wrappers take the plain versions, whatever the split."""
    w_q, scale, x = _inputs(256, 700, 3)
    xt, sc = torch.from_numpy(x), torch.from_numpy(scale)
    i8, i4 = (bench_int4.pack_int4_i8(torch.from_numpy(w_q)),
              bench_int4.pack_int4_native(torch.from_numpy(w_q)))
    before = bench_int4.LAUNCHES_V3.count, bench_int4.LAUNCHES_V4.count
    assert torch.equal(bench_int4.v3_matmul(xt, i8, sc, n_out=700, k_slices=3),
                       bench_int4.v3_matmul_plain(xt, i8, sc, n_out=700))
    assert torch.equal(bench_int4.v4_matmul(xt, i4, sc, n_out=700, k_slices=3),
                       bench_int4.v4_matmul_plain(xt, i4, sc, n_out=700))
    assert (bench_int4.LAUNCHES_V3.count, bench_int4.LAUNCHES_V4.count) == before


def test_entries_match_their_signatures():
    """Every C entry the loader binds is defined once in the sources (or the
    library would not load on the card); the int4 bench's take as many
    parameters as their ctypes signatures (ctypes would pass garbage)."""
    sources = "".join(p.read_text() for p in sorted(pathlib.Path(_build.CSRC).glob("*.cu")))
    for name, argtypes in _build._SIGNATURES.items():
        found = re.findall(rf'extern "C" int {name}\(([^)]*)\)', sources)
        assert len(found) == 1, name
        if name.startswith("teochat_bench_int4_"):
            assert found[0].count(",") + 1 == len(argtypes), name
