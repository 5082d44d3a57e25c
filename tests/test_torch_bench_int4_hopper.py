"""The int4 bench's ring body (all six S1 kernels) against the script's Pallas kernels.

The ring kernels of teochat_torch/csrc/bench_int4_kernel.cu run only on a
card. Their walk is written out in plain PyTorch as
`bench/int4_kernel.py::ring_schedule`: items of (tile, K slice) for each
chunk of 8 rows of x, K cut into the slices that `ring_k_slices` picks for
an H100 SXM's 132 SMs (or a given count), each slice walked in stages of
RING_STAGE_BYTES // tw byte rows, an fp32 partial an item, a tile's partials
summed in slice order, then the byte reuse's correction, the scale and one
rounding. Here that walk is held against scripts/bench_int4_kernel.py's
`v2_matmul`, `v3_matmul` (mask at 32 and 16 bits), `v5_matmul`,
`v4_matmul`, `dma_only_matmul` and `vpu_only`, their Pallas kernels in
interpret mode (the script passes no `interpret` flag, so for this file
alone `pallas_call` is wrapped to add it), against the port's plain versions
at more shapes; the split rule, the M > 1 consumer's byte decodes and the
module's sizes against the `.cu`.

Same seeded numpy inputs on both sides, fp32. Tolerance: 1e-4 of the
largest |reference|, as in tests/test_torch_bench_kernels.py (both sides sum
the same exact products in fp32, in other orders; v3's terms reach 16 times
the result before the correction cancels them). vpu's column sums are small
integers, so they are held equal (the script returns 8 times their total,
as it repeats each sum over 8 sublanes). Each JAX shape is one more
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
from teochat_torch.ops import int4_matmul as int4_mod
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

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


PACKERS = {"v2": int4_mod.pack_int4_tiled, "v3": bench_int4.pack_int4_i8,
           "v5": bench_int4.pack_int4_i8, "v4": bench_int4.pack_int4_native,
           "dma": int4_mod.pack_int4_tiled, "vpu": int4_mod.pack_int4_tiled}
PLAIN = {"v2": bench_int4.v2_matmul_plain, "v3": bench_int4.v3_matmul_plain,
         "v5": bench_int4.v5_matmul_plain, "v4": bench_int4.v4_matmul_plain,
         "dma": lambda x, tiles, _, n_out: bench_int4.dma_only_matmul_plain(x, tiles, n_out=n_out),
         "vpu": lambda x, tiles, _, n_out: bench_int4.vpu_only_plain(tiles)[0]}


def _walk(variant, x, w_q, scale, n, tw, k_slices, sms=bench_int4.H100_SXM_SMS):
    tiles = PACKERS[variant](torch.from_numpy(w_q), tw)
    return bench_int4.ring_schedule(
        torch.from_numpy(x), tiles, torch.from_numpy(scale), n_out=n, variant=variant,
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
    # v2 and v5 at v3's and v4's shapes: ragged slices and stages, n_out < tiles
    ("v2", 400, 700, 3, 512, 3),
    ("v5", 256, 300, 1, 128, None),
    ("v5", 400, 700, 8, 1024, 3),
    ("v2", 272, 700, 11, 512, None),
    # the probes at the same shapes; dma's M 11 reads x at a row stride of K + 64
    ("dma", 400, 700, 3, 512, 3),
    ("dma", 256, 300, 1, 128, None),
    ("dma", 400, 700, 8, 1024, 3),
    ("dma_strided", 272, 700, 11, 512, None),
    ("vpu", 400, 700, 1, 512, 3),
    ("vpu", 256, 300, 1, 128, None),
]


@pytest.mark.parametrize("variant,k,n,m,tw,k_slices", JAX_CASES)
def test_walk_matches_the_script(script, variant, k, n, m, tw, k_slices):
    w_q, scale, x = _inputs(k, n, m)
    n_pad = -(-n // tw) * tw
    scale_pad = jnp.asarray(np.pad(scale, (0, n_pad - n)))
    if variant in ("dma", "dma_strided", "vpu"):
        tiles = script.pack_int4_tiled(jnp.asarray(w_q), tw)
        if variant == "vpu":  # 8 times the total of every column's sum, padding included
            got = _walk("vpu", x, w_q, scale, n, tw, k_slices)
            assert got.dtype == torch.float32 and got.shape == (n_pad // tw, tw)
            assert 8 * got.sum().item() == float(script.vpu_only(tiles))
            # the values, unpacked and added; a padded column's zero bytes give -16 a byte row
            assert got.sum().item() == w_q.astype(np.int64).sum() - 16 * (k // 2) * (n_pad - n)
            return
        want = script.dma_only_matmul(jnp.asarray(x), tiles, n_out=n)
        xt = torch.from_numpy(np.pad(x, ((0, 0), (0, 64))))[:, :k] if variant == "dma_strided" \
            else torch.from_numpy(x)
        got = bench_int4.ring_schedule(xt, int4_mod.pack_int4_tiled(torch.from_numpy(w_q), tw),
                                       None, n_out=n, variant="dma", k_slices=k_slices)
        assert got.dtype == torch.float32 and _rel(got.numpy(), want) <= REL
        return
    if variant == "v4":
        want = script.v4_matmul(jnp.asarray(x), script.pack_int4_native(w_q, tw), scale_pad,
                                n_out=n)
    elif variant == "v2":
        want = script.v2_matmul(jnp.asarray(x), script.pack_int4_tiled(jnp.asarray(w_q), tw),
                                scale_pad, n_out=n)
    elif variant == "v5":
        want = script.v5_matmul(jnp.asarray(x), script.pack_int4_i8(w_q, tw), scale_pad, n_out=n)
    else:
        mask = jnp.int16 if variant == "v3_m16" else jnp.int32
        want = script.v3_matmul(jnp.asarray(x), script.pack_int4_i8(w_q, tw), scale_pad,
                                n_out=n, mask_dtype=mask)
    got = _walk(variant[:2], x, w_q, scale, n, tw, k_slices)
    assert got.dtype == torch.float32 and _rel(got.numpy(), want) <= REL
    exact = x.astype(np.float64) @ w_q.astype(np.float64) * scale
    assert _rel(got.numpy(), exact) <= REL


@pytest.mark.parametrize("variant", bench_int4.RING_VARIANTS)
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
    want = PLAIN[variant](torch.from_numpy(x), PACKERS[variant](torch.from_numpy(w_q), tw),
                          torch.from_numpy(scale), n_out=n)
    if variant == "vpu":  # sums of small integers: exact
        assert torch.equal(got, want)
    assert _rel(got.numpy(), want.numpy()) <= REL


def test_walk_rounds_once_in_bf16():
    """bf16 x: v4's walk divides x's odd rows by 16 (exact) and rounds once,
    so it lies within one bf16 step of the plain version's rounding."""
    w_q, scale, x = _inputs(512, 700, 3, seed=2)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    tiles = bench_int4.pack_int4_native(torch.from_numpy(w_q))
    got = bench_int4.ring_schedule(xb, tiles, torch.from_numpy(scale), n_out=700, variant="v4")
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
    with pytest.raises(ValueError, match="variant"):
        bench_int4.ring_schedule(torch.from_numpy(x[:1]), bench_int4.pack_int4_i8(
            torch.from_numpy(w_q)), torch.from_numpy(scale), n_out=128, variant="v3_m16")


@pytest.mark.parametrize("signed", [False, True])
def test_mma_byte_pair_is_exact(signed):
    """The M > 1 consumer's A operand for v2 (u8) and v5 (int8): every byte
    becomes the bf16 pair (low nibble, byte) exactly, by the `.cu`'s prmt,
    lop3 and hsub2 (written out with its constants, which are the source's)."""
    source = (pathlib.Path(_build.CSRC) / "bench_int4_kernel.cu").read_text()
    body = source[source.index("uint32_t byte_pair_bf16x2("):]
    body = body[:body.index("\n}\n")]
    assert '"prmt.b32 %0, %1, %2, %3;"' in body and "(P | (P << 8) | ((8 | P) << 12))" in body
    assert f"(h & 0x{bench_int4.PAIR_KEEP:08X}u) | 0x{bench_int4.PAIR_MAGIC:08X}u" in body
    assert (f"V == V2 ? 0x{bench_int4.PAIR_MAGIC:08X}u & ~(h & 0x{bench_int4.PAIR_SIGN_U8:08X}u)"
            in body)
    assert f": 0x{bench_int4.PAIR_MAGIC:08X}u | (h & 0x{bench_int4.PAIR_TOP_I8:08X}u)" in body
    assert "__hsub2(" in body and "I2F" not in body and "__int2" not in body
    raw = torch.arange(256, dtype=torch.int64)
    pair = bench_int4.byte_pair_bf16x2(raw, signed).float()
    byte = raw - 256 * (raw >= 128).long() if signed else raw
    assert torch.equal(pair[:, 0], (raw & 15).float())  # the low nibble, whatever the sign
    assert torch.equal(pair[:, 1], byte.float())
    # the walk's multiplicands are the same values
    variant = "v5" if signed else "v2"
    tiles = raw.to(torch.int8 if signed else torch.uint8).reshape(1, 2, 128)
    wa, wb = bench_int4._ring_decode(variant, tiles)
    assert torch.equal(wa.reshape(-1), pair[:, 0]) and torch.equal(wb.reshape(-1), pair[:, 1])


def test_mma_byte_rows_pair_is_exact():
    """dma's M > 1 A operand: every pair of u8 bytes of two byte rows becomes
    the bf16 pair (byte0, byte1) exactly, by the `.cu`'s prmt (each byte with
    its sign replicated above it), two lop3 and hsub2, with its constants."""
    source = (pathlib.Path(_build.CSRC) / "bench_int4_kernel.cu").read_text()
    body = source[source.index("uint32_t byte_rows_bf16x2("):]
    body = body[:body.index("\n}\n")]
    assert '"prmt.b32 %0, %1, %2, %3;"' in body
    assert "(P | ((8 | P) << 4) | ((4 + P) << 8) | ((12 + P) << 12))" in body
    assert f"(h & 0x{bench_int4.ROWS_KEEP:08X}u) | 0x{bench_int4.PAIR_MAGIC:08X}u" in body
    assert f"sub = 0x{bench_int4.PAIR_MAGIC:08X}u & ~h;" in body
    assert "__hsub2(" in body and "I2F" not in body and "__int2" not in body
    assert "mma_1688(acc[h][2 * q], byte_rows_bf16x2<0>(u0[q], u1[q])" in source
    raw = torch.arange(256, dtype=torch.int64)
    byte0, byte1 = raw.repeat_interleave(256), raw.repeat(256)  # all 65,536 pairs
    pair = bench_int4.byte_rows_bf16x2(byte0, byte1)
    assert pair.dtype == torch.bfloat16
    assert torch.equal(pair[:, 0].float(), byte0.float())
    assert torch.equal(pair[:, 1].float(), byte1.float())
    # the walk's multiplicand is the same value
    wa, wb = bench_int4._ring_decode("dma", raw.to(torch.uint8).reshape(1, 2, 128))
    assert wb is None and torch.equal(wa.reshape(-1), raw.float())


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
    # all six launch the ring kernels, streamed by bulk copies; v2, v4, v5 and dma take
    # M > 1 on mma.sync, v3 keeps its FMAs; the first body and its bands are gone
    body = source[source.index("void ring_body("):source.index("int ring_slice_rows(")]
    assert "MMA = MT > 1 && V != V3 && V != V3_M16;" in body
    assert "ring_consume_mma<V, MT, W>(" in body
    for gone in ("stream_body", "pick_band", "LAUNCH_BAND", "LAUNCH_PRODUCT", "band"):
        assert gone not in source, gone
    assert "X_COPIES = V == VPU ? 0 : BYTE_REUSE ? 2 : 1;" in body  # vpu copies no x
    # the byte reuse's correction: 17 sum xb for v2's u8 byte, sum xb for v3's and v5's
    assert "return V == V2 ? 17.f : 1.f;" in source
    assert "s += bf16_bits(xa[r]) + C * bf16_bits(xb[r]);" in source
    assert {v: c for v, (_, c) in bench_int4.BYTE_REUSE.items()} == {"v2": 17, "v3": 1, "v5": 1}
    assert [n // 8 * 8 for n in (42, 32, 16, 8)] == [
        bench_int4.ring_stage_rows(tw) for tw in (384, 512, 1024, 2048)]
    # one integer ticket a block, no float atomics
    assert "bulk_load_1d" in body and body.count("atom.acq_rel.gpu.global.add.s32") == 1
    assert "atomicAdd(" not in body and "red." not in body
    assert "__int2float" not in source and "bfe" not in source
    for variant in bench_int4.RING_VARIANTS:
        entry, kernel = f"teochat_bench_int4_{variant}", f"bench_int4_{variant}_ring_kernel"
        launch = source[source.index(f'"C" int {entry}('):]
        assert f"RING_LAUNCH({kernel})" in launch[:launch.index("\n}\n")]
    header = (pathlib.Path(_build.CSRC) / "hopper_async.cuh").read_text()
    assert "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1]" \
        in header


def test_sass_names_are_found():
    """`sass_counts` keys each ring kernel's M = 1 instantiation by its
    variant, and its M = 8 one (vpu's, never launched, is not keyed); the
    first body's names are no longer keyed."""
    names = {
        "_ZN12_GLOBAL__N_120bench_int4_v2_kernelILi32ELi1EEEvNS_4ArgsE": None,
        "_ZN12_GLOBAL__N_125bench_int4_v3_ring_kernelILi1EEEvNS_8RingArgsE": "v3_ring",
        "_ZN12_GLOBAL__N_125bench_int4_v4_ring_kernelILi1EEEvNS_8RingArgsE": "v4_ring",
        "_ZN12_GLOBAL__N_125bench_int4_v4_ring_kernelILi8EEEvNS_8RingArgsE": "v4_ring m8",
        "_ZN12_GLOBAL__N_125bench_int4_v5_ring_kernelILi1EEEvNS_8RingArgsE": "v5_ring",
        "_ZN12_GLOBAL__N_125bench_int4_v2_ring_kernelILi8EEEvNS_8RingArgsE": "v2_ring m8",
        "_ZN12_GLOBAL__N_126bench_int4_dma_ring_kernelILi1EEEvNS_8RingArgsE": "dma_ring",
        "_ZN12_GLOBAL__N_126bench_int4_dma_ring_kernelILi8EEEvNS_8RingArgsE": "dma_ring m8",
        "_ZN12_GLOBAL__N_126bench_int4_vpu_ring_kernelILi1EEEvNS_8RingArgsE": "vpu_ring",
        "_ZN12_GLOBAL__N_126bench_int4_vpu_ring_kernelILi8EEEvNS_8RingArgsE": None,
        "_ZN12_GLOBAL__N_121bench_int4_dma_kernelILi128ELi1EEEvNS_4ArgsE": None,
        "_ZN12_GLOBAL__N_121bench_int4_dma_kernelILi32ELi8EEEvNS_4ArgsE": None,
    }
    for name, key in names.items():
        assert bench_int4.sass_key(name) == key


def test_cpu_wrappers_take_the_plain_versions():
    """On the CPU the wrappers take the plain versions, whatever the split."""
    w_q, scale, x = _inputs(256, 700, 3)
    xt, sc = torch.from_numpy(x), torch.from_numpy(scale)
    wrappers = {"v2": bench_int4.v2_matmul, "v3": bench_int4.v3_matmul,
                "v5": bench_int4.v5_matmul, "v4": bench_int4.v4_matmul}
    before = {v: bench_int4.COUNTERS[f"S1-{v}"].count for v in wrappers}
    for variant, wrapper in wrappers.items():
        tiles = PACKERS[variant](torch.from_numpy(w_q))
        assert torch.equal(wrapper(xt, tiles, sc, n_out=700, k_slices=3),
                           PLAIN[variant](xt, tiles, sc, n_out=700))
    probes = {"S1-dma": bench_int4.LAUNCHES_DMA.count, "S1-vpu": bench_int4.LAUNCHES_VPU.count}
    tiles = int4_mod.pack_int4_tiled(torch.from_numpy(w_q))
    assert torch.equal(bench_int4.dma_only_matmul(xt, tiles, n_out=700, k_slices=3),
                       bench_int4.dma_only_matmul_plain(xt, tiles, n_out=700))
    cols, total = bench_int4.vpu_only(tiles, k_slices=3)
    want_cols, want_total = bench_int4.vpu_only_plain(tiles)
    assert torch.equal(cols, want_cols) and total.item() == want_total.item()
    assert torch.equal(bench_int4.vpu_column_sums(tiles, k_slices=3), want_cols)
    assert {v: bench_int4.COUNTERS[f"S1-{v}"].count for v in wrappers} == before
    assert {k: bench_int4.COUNTERS[k].count for k in probes} == probes


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
