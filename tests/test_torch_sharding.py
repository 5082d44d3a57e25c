"""The port's placement rules and mesh against the JAX package's, on the CPU.

- the rule table is JAX's, pattern for pattern; `param_specs` gives JAX's
  PartitionSpec for every leaf of tiny LLaMA, int8, int4 (fused and
  tiled), LoRA, multi-LoRA, MPT and MPT int8 + LoRA trees, with no mesh
  and fitted to JAX's 8-device virtual meshes (tests/conftest.py);
- `mesh_shape` gives JAX's `create_mesh` shapes and raises its errors;
- the port's own refinements: `placement_specs` replicates a block whose
  heads the `model` axis does not divide (TinyLlama's 4 kv heads over 8),
  `local_chunk` lays a fused leaf out per rank and `canonical_columns`
  undoes it, bitwise;
- a one-rank gloo mesh (1, 1, 1) runs every mesh code path at degree 1: a
  train step on it equals the meshless step to 1e-6 relative (the same
  products; the gathers and the reductions are identities), and a
  sequence or pipe axis of 2 on one rank raises JAX's mesh-size error (the
  axes run on ranks: tests/test_torch_parallel_train.py);
- on meshes with `sequence` and `pipe` axes every leaf's spec is JAX's (a
  decoder layer leaf's unsharded leading dim takes `pipe`).
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax

from teochat_tpu.config import MeshConfig as JaxMeshConfig
from teochat_tpu.config import MptConfig, tiny_test_config
from teochat_tpu.models import teochat as jax_teochat
from teochat_tpu.ops import quant as jax_quant
from teochat_tpu.parallel import mesh as jax_mesh
from teochat_tpu.parallel import sharding as jax_sharding
from teochat_tpu.train import lora as jax_lora
from teochat_torch.config import MeshConfig, TEOChatConfig
from teochat_torch.parallel import mesh as torch_mesh
from teochat_torch.parallel import sharding as torch_sharding
from teochat_torch.utils import tree_leaves_with_path
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _trees():
    base = tiny_test_config(vocab_size=128)
    cfg = dataclasses.replace(base, llm=dataclasses.replace(base.llm, num_kv_heads=2))
    params = _np(jax_teochat.init_teochat(jax.random.PRNGKey(0), cfg))
    llm = params["llm"]
    q8 = _np(jax_quant.quantize_llama_params(llm))
    lora = [_np(jax_lora.add_lora_params(jax.random.PRNGKey(s), q8, rank=4)) for s in (1, 2)]
    wide = dataclasses.replace(base.llm, hidden_size=512, intermediate_size=1024, num_heads=8,
                               num_kv_heads=8, vocab_size=512)
    from teochat_tpu.models import llama as jax_llama

    wide_llm = jax_llama.init_llama(jax.random.PRNGKey(3), wide)
    mpt_cfg = dataclasses.replace(base, llm=MptConfig(vocab_size=128, d_model=64, n_layers=2,
                                                      n_heads=4, expansion_ratio=2),
                                  llm_backend="mpt")
    mpt = _np(jax_teochat.init_teochat(jax.random.PRNGKey(4), mpt_cfg))
    mpt_lora = _np(jax_lora.add_lora_params(
        jax.random.PRNGKey(5), _np(jax_quant.quantize_mpt_params(mpt["llm"])), rank=4))
    return {
        "llama": params,
        "int8": {**params, "llm": q8},
        "int4_flat": {"llm": _np(jax_quant.quantize_llama_params_int4(llm))},
        "int4_tiled_fused": {"llm": _np(jax_quant.quantize_llama_params_int4(wide_llm))},
        "int4_tiled": {"llm": _np(jax_quant.quantize_llama_params_int4(
            wide_llm, fuse_projections=False))},
        "lora": {**params, "llm": lora[0]},
        "multi_lora": {**params, "llm": _np(jax_lora.stack_lora_adapters(lora))},
        "mpt": mpt,
        "mpt_int8_lora": {**mpt, "llm": mpt_lora},
    }


TREE_NAMES = ["llama", "int8", "int4_flat", "int4_tiled_fused", "int4_tiled", "lora",
              "multi_lora", "mpt", "mpt_int8_lora"]
JAX_MESHES = [None, (2, 2, 2), (1, 4, 2), (1, 8, 1), (2, 1, 4)]


def test_rule_table_is_jax():
    assert len(torch_sharding._RULES) == len(jax_sharding._RULES)
    for (tp, ts), (jp, js) in zip(torch_sharding._RULES, jax_sharding._RULES):
        assert tp == jp and ts == tuple(js), (tp, jp)
    assert torch_sharding.spec_for_path("anything/else") == tuple(jax_sharding._DEFAULT)


@pytest.fixture(scope="module")
def trees():
    return _trees()


@pytest.mark.parametrize("name", TREE_NAMES)
def test_param_specs_match_jax_leaf_for_leaf(trees, name):
    """Every leaf's spec, with no mesh and on each of JAX_MESHES."""
    tree = trees[name]
    for mesh in JAX_MESHES:
        jmesh = None if mesh is None else jax_mesh.create_mesh(JaxMeshConfig(*mesh))
        want = jax_sharding.param_specs(tree, jmesh)
        got = torch_sharding.param_specs(tree, None if jmesh is None else dict(jmesh.shape))
        for path, _ in tree_leaves_with_path(tree):
            w, g = tuple(_spec_at(want, path)), _spec_at(got, path)
            assert g == w, (mesh, path, g, w)


# (data, fsdp, model, sequence, pipe) over the 8 virtual devices
JAX_CP_MESHES = [(1, 2, 1, 2, 2), (1, 1, 2, 1, 4), (1, 4, 1, 2, 1), (2, 1, 1, 1, 4)]


@pytest.mark.parametrize("name", TREE_NAMES)
def test_param_specs_on_sequence_and_pipe_meshes_match_jax(trees, name):
    """Every leaf's spec on meshes with `sequence` and `pipe` axes: the
    decoder's layer leaves take `pipe` on their leading dim where it is
    unsharded (and divides), nothing takes `sequence`."""
    tree = trees[name]
    for mesh in JAX_CP_MESHES:
        jmesh = jax_mesh.create_mesh(JaxMeshConfig(*mesh))
        want = jax_sharding.param_specs(tree, jmesh)
        got = torch_sharding.param_specs(tree, dict(jmesh.shape))
        for path, _ in tree_leaves_with_path(tree):
            w, g = tuple(_spec_at(want, path)), _spec_at(got, path)
            assert g == w, (mesh, path, g, w)


def _spec_at(specs, path):
    node = specs
    for k in path.split("/"):
        node = node[int(k)] if isinstance(node, list) else node[k]
    return node


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, -1, 2), (-1, 1, 1), (1, -1, 1), (2, 4, 1),
                                   (3, 1, 1), (-1, -1, 1), (1, 3, -1)])
def test_mesh_shapes_and_errors_match_jax(shape):
    try:
        want = tuple(jax_mesh.create_mesh(JaxMeshConfig(*shape)).devices.shape)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            torch_mesh.mesh_shape(MeshConfig(*shape), 8)
        return
    sizes, names = torch_mesh.mesh_shape(MeshConfig(*shape), 8)
    assert tuple(sizes) == want and names == ["data", "fsdp", "model"]


def test_mesh_axis_errors_match_jax():
    for kw in (dict(sequence=0), dict(pipe=0), dict(sequence=2, fsdp=-1)):
        try:
            want = tuple(jax_mesh.create_mesh(JaxMeshConfig(**kw)).devices.shape)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                torch_mesh.mesh_shape(MeshConfig(**kw), 8)
            continue
        assert tuple(torch_mesh.mesh_shape(MeshConfig(**kw), 8)[0]) == want
    assert tuple(jax_mesh.local_mesh().devices.shape) == tuple(
        torch_mesh.mesh_shape(MeshConfig(data=1, fsdp=-1, model=1), 8)[0])


def test_batch_spec_is_jax():
    for train in (False, True):
        assert torch_sharding.batch_spec(train) == tuple(jax_sharding.batch_spec(train))


def test_placement_specs_replicate_what_model_cannot_split():
    """TinyLlama's geometry scaled down: 8 heads, 4 kv heads, over model 8:
    the attention block replicates over `model` whole (its fsdp placement
    kept), the MLP and the vocabulary split as JAX's rules say."""
    base = tiny_test_config(vocab_size=128)
    llm_cfg = dataclasses.replace(base.llm, hidden_size=128, num_heads=8, num_kv_heads=4,
                                  intermediate_size=256)
    cfg = TEOChatConfig.from_json(dataclasses.replace(base, llm=llm_cfg).to_json())
    from teochat_tpu.models import llama as jax_llama

    tree = {"llm": _np(jax_llama.init_llama(jax.random.PRNGKey(0), llm_cfg))}
    mesh = {"data": 1, "fsdp": 2, "model": 8}
    plain = torch_sharding.param_specs(tree, mesh)
    placed = torch_sharding.placement_specs(tree, mesh, cfg)
    for path, _ in tree_leaves_with_path(tree):
        p, g = _spec_at(plain, path), _spec_at(placed, path)
        if path.startswith("llm/layers/attn/"):
            assert g == tuple(None if a == "model" else a for a in p), path
        else:
            assert g == p, path
    assert _spec_at(placed, "llm/layers/attn/q/kernel") == (None, "fsdp", None)
    assert _spec_at(placed, "llm/layers/mlp/gate/kernel") == (None, "fsdp", "model")


@pytest.mark.parametrize("m", [1, 2, 4])
def test_fused_leaf_is_laid_out_per_rank_and_back(m):
    """MPT's wqkv [q | k | v] over model m: rank r's block is [its q
    columns | its k | its v], and the ranks' blocks together go back to the
    canonical columns bitwise."""
    cfg = TEOChatConfig.from_json(dataclasses.replace(
        tiny_test_config(), llm=MptConfig(d_model=64, n_heads=4, n_layers=1,
                                          vocab_size=128), llm_backend="mpt").to_json())
    segs = torch_sharding.fused_segments("llm/layers/wqkv/kernel", cfg)
    assert segs == (64, 64, 64)
    x = torch.arange(2 * 8 * 192, dtype=torch.float32).reshape(2, 8, 192)
    spec = (None, None, "model")
    blocks = [torch_sharding.local_chunk(x, spec, {"model": m}, {"model": r}, segs)
              for r in range(m)]
    for r, blk in enumerate(blocks):
        want = torch.cat([seg.chunk(m, -1)[r] for seg in x.split(list(segs), -1)], -1)
        assert torch.equal(blk, want)
    assert torch.equal(torch_sharding.canonical_columns(torch.cat(blocks, -1), segs, m), x)
    assert torch_sharding.fused_segments("llm/layers/wqkv/lora_a", cfg) is None


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo process group in this process, destroyed after."""
    import torch.distributed as dist

    init = tmp_path_factory.mktemp("pg") / "init"
    torch_mesh.init_distributed("cpu", init_method=f"file://{init}", rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_one_rank_mesh_step_equals_the_meshless_step(one_rank):
    """Every mesh code path at degree 1 (gathers, the model collectives, the
    row sums, the sharded checkpoint's format) against the meshless step."""
    from tests import _torch_dist
    from tests.test_torch_parallel_train import OPT, _rows

    base = dataclasses.replace(tiny_test_config(vocab_size=128), dtype="float32")
    params = _np(jax_teochat.init_teochat(jax.random.PRNGKey(7), base))
    variant = dict(cfg=TEOChatConfig.from_json(base.to_json()).to_json(), filter="full",
                   dtype="float32", opt=OPT, params=params)
    batches = [_rows(s, 128) for s in range(2)]
    mesh = torch_mesh.create_mesh(MeshConfig(1, 1, 1), "cpu")
    state, losses, _ = _torch_dist.run_steps(variant, batches, mesh=mesh)
    ref, ref_losses, _ = _torch_dist.run_steps(variant, batches)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-6)
    cfg = TEOChatConfig.from_json(variant["cfg"])
    got = _torch_dist.full_tree(state.params, cfg)
    for path, x in tree_leaves_with_path(ref.params):
        np.testing.assert_allclose(got[path], x.detach().numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=path)
    for kw in (dict(sequence=2), dict(pipe=2)):
        with pytest.raises(ValueError, match=re.escape("!= 1 devices")):
            torch_mesh.create_mesh(MeshConfig(**kw), "cpu")
