"""Ring attention (teochat_torch/parallel/ring_attention.py) on gloo ranks
against JAX's `context_parallel_attention` on as many of conftest's virtual
devices.

The ranks (tests/_torch_dist.py, scenario `ring`) run every case on a
`sequence` mesh of 2 and of 4 ranks in two forms: the plain twin (JAX's
form, through autograd and the rotations' reverse sends) and the kernel
path (`_RingFlash`: K4a's pairs combined in fp32, K4b / K4c on the global
statistics, dK and dV travelling home) with the kernels' tile walks in
place of the card's kernels. Each output and the q / k / v gradients of
sum(out * w) are gathered whole. The JAX references are computed once a
module (the XLA CPU compiler dies after ~350 compilations in a process).

Tolerances are JAX's own (tests/test_ring_attention.py): the forward
within 2e-5, the gradients within 2e-4 (fp32; the walks and the plain
twin sum in other orders than XLA).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from teochat_torch.ops import flash_attention as flash_mod
from teochat_torch.ops.attention import plain_attention
from teochat_torch.parallel import ring_attention as ring
from teochat_tpu.parallel.ring_attention import context_parallel_attention
from tests import _torch_dist
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

FWD_TOL = 2e-5
GRAD_TOL = 2e-4
WORLDS = (2, 4)
# (q shape, kv heads, causal)
CASES = {
    "causal": ((2, 64, 4, 16), 4, True),
    "full": ((2, 64, 4, 16), 4, False),
    "gqa": ((2, 64, 4, 16), 2, True),
    "mqa": ((1, 32, 4, 8), 1, True),
}


def _case(name, seed):
    (b, s, h, d), hkv, causal = CASES[name]
    rs = np.random.RandomState(seed)
    q = (rs.randn(b, s, h, d) * 0.5).astype(np.float32)
    k, v = ((rs.randn(b, s, hkv, d) * 0.5).astype(np.float32) for _ in range(2))
    return dict(q=q, k=k, v=v, w=rs.randn(b, s, h, d).astype(np.float32), causal=causal)


@pytest.fixture(scope="module")
def cases():
    return {name: _case(name, i) for i, name in enumerate(CASES)}


@pytest.fixture(scope="module")
def jax_refs(cases):
    """JAX's ring on 2 and 4 virtual devices: {(case, n): (out, dq, dk, dv)}."""
    out = {}
    for n in WORLDS:
        mesh = Mesh(np.array(jax.devices()[:n]), ("sequence",))
        for name, c in cases.items():
            def loss(q, k, v, c=c, mesh=mesh):
                o = context_parallel_attention(q, k, v, mesh, causal=c["causal"])
                return jnp.sum(o * c["w"]), o

            (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
                *(jnp.asarray(c[x]) for x in ("q", "k", "v")))
            out[name, n] = [np.asarray(o)] + [np.asarray(g) for g in grads]
    return out


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ring"))
    torch.save({"ring": cases}, os.path.join(out, "setup.pt"))
    got = {}
    for n in WORLDS:
        _torch_dist.launch(n, out, ["ring"])
        got[n] = torch.load(os.path.join(out, f"ring_{n}.pt"), weights_only=False)
    return got


@pytest.mark.parametrize("form", ["plain", "walks"])
@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_ring_matches_jax(ranks, jax_refs, name, n, form):
    """The port's ring on n gloo ranks, whole, against JAX's on n devices:
    causal and not, GQA and multiquery (blocks rotate at Hkv width)."""
    got = ranks[n]["out"][f"{name}_{form}"]
    want = jax_refs[name, n]
    np.testing.assert_allclose(got[0], want[0], rtol=FWD_TOL, atol=FWD_TOL)
    for g, w, what in zip(got[1:], want[1:], "qkv"):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=f"d{what}")


@pytest.mark.parametrize("n", WORLDS)
def test_ring_errors_match_jax(ranks, n):
    """A length the ring does not divide raises JAX's "not divisible"; query
    heads GQA cannot group raise before anything is sent."""
    errors = ranks[n]["errors"]
    assert errors["not_divisible"] == f"sequence length {6 * n + 1} not divisible by sequence={n}"
    assert "not a multiple of kv heads" in errors["heads"]
    x = jnp.zeros((1, 6 * n + 1, 2, 8))
    mesh = Mesh(np.array(jax.devices()[:n]), ("sequence",))
    with pytest.raises(ValueError, match="not divisible") as jax_err:
        context_parallel_attention(x, x, x, mesh)
    assert str(jax_err.value) == errors["not_divisible"]


def test_ring_pairs_launch_n_n_plus_1_over_2():
    """A causal ring launches rank i's i + 1 pairs (the diagonal causal, the
    earlier ranks' blocks whole), n(n+1)/2 over the ranks; a full one n^2."""
    for n in range(1, 9):
        pairs = [ring.ring_pairs(n, r, True) for r in range(n)]
        assert [len(p) for p in pairs] == [r + 1 for r in range(n)]
        assert sum(map(len, pairs)) == n * (n + 1) // 2
        assert all(p[0] is True and not any(c for i, c in p.items() if i) for p in pairs)
        assert sum(len(ring.ring_pairs(n, r, False)) for r in range(n)) == n * n


def test_combined_pairs_equal_one_attention():
    """K4a's (o, m, l) of each key block (its tile walk), combined in fp32,
    give the whole row's attention and its statistics: the forward's
    arithmetic without a rank."""
    rs = np.random.RandomState(7)
    q = torch.from_numpy(rs.randn(2, 48, 4, 16).astype(np.float32))
    k = torch.from_numpy(rs.randn(2, 144, 2, 16).astype(np.float32))
    v = torch.from_numpy(rs.randn(2, 144, 2, 16).astype(np.float32))
    parts = [flash_mod.flash_forward_schedule(q, kb, vb, causal=False)
             for kb, vb in zip(k.split(48, 1), v.split(48, 1))]
    o, m, l = ring.combine_partials(parts)
    want_m, want_l = flash_mod.flash_statistics_plain(q, k, v, causal=False)
    np.testing.assert_allclose(o, plain_attention(q, k, v), rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(m, want_m, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(l, want_l, rtol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_kernel_path_in_one_process_matches_plain_autograd(n):
    """`ring_flash_one_process` (the card test's and the smoke's form: the
    rotation replaced by indexing) with the kernels' walks, GQA: the whole
    output and gradients equal plain attention's autograd."""
    c = _case("gqa", 11)
    q, k, v = (torch.from_numpy(c[x]).requires_grad_() for x in ("q", "k", "v"))
    do = torch.from_numpy(c["w"])
    o = plain_attention(q, k, v, causal=True)
    want = [o.detach()] + list(torch.autograd.grad(o, (q, k, v), do))
    got = ring.ring_flash_one_process(q.detach(), k.detach(), v.detach(), do, n,
                                      kernels=ring.schedule_kernels())
    np.testing.assert_allclose(got[0], want[0], rtol=FWD_TOL, atol=FWD_TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL)
