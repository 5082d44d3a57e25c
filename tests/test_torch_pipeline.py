"""GPipe over a `pipe` axis (teochat_torch/parallel/pipeline.py) on gloo
ranks, against the unpipelined stack on one process and JAX's
`pipelined_scan_blocks` on conftest's virtual devices.

The ranks (tests/_torch_dist.py, scenario `pipeline`) run the decoder
cache-free with `pipeline_axis` on a `pipe` mesh of 2 and of 4 ranks (8
LLaMA layers; 4 MPT layers, whose ALiBi table closes over the block and
whose padding mask travels), remat on: the logits, and the gradients of
sum(logits * probe) for the input and every layer leaf, whole. The JAX
references (its pipeline on 4 devices) are computed once a module.

Tolerances are JAX's own (tests/test_pipeline.py): logits within 2e-5
(with a padding mask, on the valid positions), gradients within 5e-5
(fp32: the microbatches sum the layers' gradients in another order).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from teochat_torch.checkpoint.bridge import to_torch
from teochat_torch.config import TEOChatConfig as TorchConfig
from teochat_torch.models import llama as torch_llama
from teochat_torch.models import mpt as torch_mpt
from teochat_tpu.config import LlamaConfig, MeshConfig, MptConfig, TEOChatConfig
from teochat_tpu.models import llama as jax_llama
from teochat_tpu.models import mpt as jax_mpt
from teochat_tpu.parallel.mesh import create_mesh
from teochat_tpu.parallel.sharding import shard_params
from teochat_torch.utils import tree_leaves_with_path
from tests import _torch_dist
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

FWD_TOL = 2e-5
GRAD_TOL = 5e-5
WORLDS = (2, 4)
LLAMA = LlamaConfig(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=8,
                    num_heads=4, num_kv_heads=4, max_position_embeddings=64)
MPT = MptConfig(vocab_size=128, d_model=32, n_layers=4, n_heads=4, expansion_ratio=2,
                max_seq_len=64)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def cases():
    """{name: case}: the decoder, its inputs and the microbatch counts."""
    rs = np.random.RandomState(0)
    b, s = 4, 16
    x = (rs.randn(b, s, 32) * 0.1).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int64).copy()
    probe = (rs.randn(b, s, 128) * 0.01).astype(np.float32)
    mask = rs.rand(b, s) > 0.2
    llama = _np(jax_llama.init_llama(jax.random.PRNGKey(0), LLAMA, jnp.float32))
    mpt = _np(jax_mpt.init_mpt(jax.random.PRNGKey(1), MPT, jnp.float32))
    llama_cfg = TEOChatConfig(llm=LLAMA)
    mpt_cfg = TEOChatConfig(llm=MPT, llm_backend="mpt")
    common = dict(x=x, pos=pos, probe=probe)
    return {
        "llama": dict(cfg=llama_cfg, llm=llama, mask=None, microbatches=(None, 2, 4), **common),
        "llama_mask": dict(cfg=llama_cfg, llm=llama, mask=mask, microbatches=(None,), **common),
        "mpt": dict(cfg=mpt_cfg, llm=mpt, mask=None, microbatches=(None, 2), **common),
    }


def _jax_forward(case, mb):
    """JAX's pipelined logits on a pipe mesh of 4 devices (mb None: the stage count)."""
    cfg = dataclasses.replace(case["cfg"].llm, pipeline_axis="pipe", pipeline_microbatches=mb)
    mask = None if case["mask"] is None else jnp.asarray(case["mask"])
    x, pos = jnp.asarray(case["x"]), jnp.asarray(case["pos"])

    def fwd(p):
        if isinstance(cfg, MptConfig):
            return jax_mpt.mpt_forward(p, cfg, x, attention_mask=mask, remat=True)[0]
        return jax_llama.llama_forward(p, cfg, x, position_ids=pos, attention_mask=mask,
                                       right_padded=mask is None, remat=True)[0]
    return fwd


@pytest.fixture(scope="module")
def jax_refs(cases):
    """{(case, mb): logits}, and the llama case's layer gradients."""
    mesh = create_mesh(MeshConfig(pipe=4), devices=jax.devices()[:4])
    out = {}
    with jax.set_mesh(mesh):
        for name, case in cases.items():
            params = shard_params({"llm": jax.tree.map(jnp.asarray, case["llm"])}, mesh)["llm"]
            for mb in case["microbatches"]:
                out[name, mb] = np.asarray(jax.jit(_jax_forward(case, mb))(params))
            if name == "llama":
                probe = jnp.asarray(case["probe"])
                fwd = _jax_forward(case, None)
                grads = jax.jit(jax.grad(lambda p: jnp.sum(fwd(p) * probe)))(params)
                out["llama_grads"] = dict(tree_leaves_with_path(_np(grads)["layers"]))
    return out


def _port_cfg(cfg):
    return TorchConfig.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def one_process(cases):
    """The port's unpipelined stack on one process: {name: (logits, dx, layer grads)}."""
    out = {}
    for name, case in cases.items():
        cfg = _port_cfg(case["cfg"]).llm
        llm = to_torch(case["llm"], "cpu")
        leaves = {p: t.requires_grad_() for p, t in tree_leaves_with_path(llm["layers"])}
        x = torch.from_numpy(case["x"]).requires_grad_()
        mask = None if case["mask"] is None else torch.from_numpy(case["mask"])
        if name == "mpt":
            logits = torch_mpt.mpt_forward(llm, cfg, x, attention_mask=mask,
                                           right_padded=mask is None, remat=True)
        else:
            logits = torch_llama.llama_forward(
                llm, cfg, x, position_ids=torch.from_numpy(case["pos"]), attention_mask=mask,
                right_padded=mask is None, remat=True)
        got = torch.autograd.grad((logits * torch.from_numpy(case["probe"])).sum(),
                                  [x, *leaves.values()])
        out[name] = (logits.detach().numpy(), got[0].numpy(),
                     {p: g.numpy() for p, g in zip(leaves, got[1:])})
    return out


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pipe"))
    port = {name: {**case, "cfg": _port_cfg(case["cfg"]).to_json()}
            for name, case in cases.items()}
    torch.save({"pipe": port}, os.path.join(out, "setup.pt"))
    got = {}
    for n in WORLDS:
        _torch_dist.launch(n, out, ["pipeline"])
        got[n] = torch.load(os.path.join(out, f"pipe_{n}.pt"), weights_only=False)
    return got


def _valid(case):
    return 1.0 if case["mask"] is None else case["mask"][..., None]


RUNS = [(name, mb) for name, mbs in (("llama", (None, 2, 4)), ("llama_mask", (None,)),
                                     ("mpt", (None, 2))) for mb in mbs]


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name,mb", RUNS, ids=[f"{n}-m{m}" for n, m in RUNS])
def test_pipeline_matches_the_stack_and_jax(cases, ranks, one_process, jax_refs, name, mb, n):
    """Logits on n stages against the unpipelined stack and JAX's pipeline;
    the input's and every layer leaf's gradients against the stack's (a
    padding mask rides with its microbatch: valid positions compared)."""
    case = cases[name]
    got = ranks[n]["out"][f"{name}_m{mb}"]
    logits, dx, grads = one_process[name]
    valid = _valid(case)
    for want in (logits, jax_refs[name, mb]):
        np.testing.assert_allclose(got["logits"] * valid, want * valid, rtol=FWD_TOL,
                                   atol=FWD_TOL)
    np.testing.assert_allclose(got["dx"], dx, rtol=GRAD_TOL, atol=GRAD_TOL)
    assert sorted(got["grads"]) == sorted(grads)
    for path, g in grads.items():
        np.testing.assert_allclose(got["grads"][path], g, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=path)


@pytest.mark.parametrize("n", WORLDS)
def test_pipeline_gradients_match_jax(ranks, jax_refs, n):
    """Every layer leaf's gradient through the pipeline equals JAX's
    through its pipeline (the stage count's microbatches)."""
    got = ranks[n]["out"]["llama_mNone"]["grads"]
    want = jax_refs["llama_grads"]
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=path)


@pytest.mark.parametrize("n", WORLDS)
def test_pipeline_shape_errors_as_jax_words_them(ranks, n):
    errors = ranks[n]["errors"]
    assert errors["layers"] == f"3 layers not divisible by pipe={n}"
    assert errors["batch"] == "batch 4 not divisible by 3 microbatches"


@pytest.mark.parametrize("what", ["sequence", "adapter_route"])
def test_pipeline_refuses_what_jax_refuses(cases, what):
    """sequence_axis with pipeline_axis, and an adapter route, raise JAX's
    errors before anything runs."""
    case = cases["llama"]
    kw = dict(pipeline_axis="pipe", **({"sequence_axis": "sequence"} if what == "sequence"
                                       else {}))
    route = np.ones((4, 2), np.float32) if what == "adapter_route" else None
    with pytest.raises(ValueError) as jax_err:
        jax_llama.llama_forward(
            jax.tree.map(jnp.asarray, case["llm"]), dataclasses.replace(LLAMA, **kw),
            jnp.asarray(case["x"]), position_ids=jnp.asarray(case["pos"]), right_padded=True,
            adapter_route=None if route is None else jnp.asarray(route))
    with pytest.raises(ValueError) as port_err:
        torch_llama.llama_forward(
            to_torch(case["llm"], "cpu"), dataclasses.replace(_port_cfg(case["cfg"]).llm, **kw),
            torch.from_numpy(case["x"]), position_ids=torch.from_numpy(case["pos"]),
            right_padded=True, adapter_route=None if route is None else torch.from_numpy(route))
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("name", ["llama", "mpt"])
def test_cache_on_a_mesh_and_cache_sequence_axis_stay_unported(cases, name):
    """What item 16.3-16.4 will port still raises, naming the item: a KV
    cache with a mesh, and `cache_sequence_axis` (the sharded cache)."""
    case = cases[name]
    cfg = _port_cfg(case["cfg"]).llm
    llm = to_torch(case["llm"], "cpu")
    x = torch.from_numpy(case["x"][:, :1])
    one = torch.zeros(4, 1, dtype=torch.long)
    n_layers = cfg.n_layers if name == "mpt" else cfg.num_layers
    kv_heads = cfg.num_kv_heads
    head_dim = cfg.d_model // cfg.n_heads if name == "mpt" else cfg.head_dim
    cache = torch_llama.KVCache(*(torch.zeros(n_layers, 4, 8, kv_heads, head_dim)
                                  for _ in range(2)))

    def forward(c, **kw):
        if name == "mpt":
            return torch_mpt.mpt_forward(llm, c, x, cache=cache, write_slots=one, **kw)
        return torch_llama.llama_forward(llm, c, x, position_ids=one, cache=cache,
                                         write_slots=one, **kw)

    with pytest.raises(NotImplementedError, match="KV cache on a mesh.*item 16"):
        forward(cfg, sharded=object())
    with pytest.raises(NotImplementedError, match="cache_sequence_axis.*item 16"):
        forward(dataclasses.replace(cfg, cache_sequence_axis="sequence"))
