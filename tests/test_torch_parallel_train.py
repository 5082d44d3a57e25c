"""Training on the port's (data, fsdp, model) mesh, on the CPU: gloo ranks
against one process, and the one process against JAX's GSPMD step.

The ranks (tests/_torch_dist.py: subprocesses with a `file://` rendezvous,
one thread each) run 3 optimizer steps of three variants on meshes
(1, 4, 1), (2, 2, 1) and (1, 2, 2) (4 ranks) and (1, 1, 2) (2 ranks), a
global batch of 4 rows of unequal valid lengths a step, each rank its
(data, fsdp) chunk of the rows:
- tiny LLaMA, int8 backbone + LoRA (the recipe's trainable set), fp32;
- tiny LLaMA, full fine-tuning with the tower training, bf16 activations;
- tiny LLaVA-MPT, int8 backbone + LoRA on its fused wqkv, fp32.
The clip (max_grad_norm 0.05) is active at every step.

Tolerances, with their reasons:
- fp32, mesh against one process: each loss 1e-5 relative, each trained
  leaf's change 1e-3 relative L2 (the same arithmetic, summed in another
  order over the ranks; Adam divides small gradients' noise by their size);
  every frozen leaf bitwise; the clip's squared global norm 1e-5 relative;
- bf16, mesh against one process: each loss 1e-2 relative, each trained
  leaf's change 1.5e-1 relative L2 (PERF.md section 4's micro-step bounds:
  bf16 rounds the differently ordered sums);
- one process against JAX's train step on its (2, 2, 2) mesh and on one
  device: losses 1e-5 relative (fp32) or 1e-2 (bf16), leaves 5e-2 relative
  L2 (tests/test_torch_train.py's bound: Adam steps on gradients below fp32
  noise in the tiny model); in bf16 the trained leaves' changes together
  1.5e-1 and each leaf's 2.5e-1 (the one process's bf16 path against JAX's,
  which this slice does not change: 5.1e-2 together, the tower's ln2 bias,
  whose gradients are small, 1.6e-1, measured when the test was written);
- the decoder's sharded logits against one device: 1e-5 of the largest
  (a fused int8 q|k|v and gate|up laid out per rank, and MPT's wqkv with
  each rank's ALiBi slopes);
- bf16 row-parallel products (int8, int8 + LoRA, bf16) on (1, 1, 2): at
  least 99 % of the outputs one device's bits (a double rounding agrees on
  ~63 % of them);
- checkpoints: bitwise.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from teochat_tpu.config import MeshConfig as JaxMeshConfig
from teochat_tpu.config import MptConfig, tiny_test_config
from teochat_tpu.models import fusion as jax_fusion
from teochat_tpu.models import teochat as jax_teochat
from teochat_tpu.ops import quant as jax_quant
from teochat_tpu.parallel import create_mesh as jax_create_mesh
from teochat_tpu.parallel import shard_params as jax_shard_params
from teochat_tpu.train import lora as jax_lora
from teochat_tpu.train import train as jax_train_mod
from teochat_tpu.train import trainer as jax_trainer
from teochat_torch.checkpoint import orbax_io
from teochat_torch.checkpoint.bridge import to_torch
from teochat_torch.config import TEOChatConfig
from teochat_torch.models import llama as torch_llama
from teochat_torch.models import mpt as torch_mpt
from teochat_torch.train import train as torch_train_mod
from teochat_torch.utils import tree_leaves_with_path
from tests import _torch_dist
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

IMG = -200
MESHES_4 = [(1, 4, 1), (2, 2, 1), (1, 2, 2)]
MESHES_2 = [(1, 1, 2)]
FP32 = dict(loss=1e-5, leaf=1e-3)
BF16 = dict(loss=1e-2, leaf=1.5e-1)
JAX_LEAF = 5e-2
JAX_BF16_LEAF = 2.5e-1
OPT = dict(learning_rate=1e-3, projector_lr=2e-3, lr_scheduler_type="constant",
           max_grad_norm=0.05, total_steps=10)
MPT_KW = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, expansion_ratio=2,
              max_seq_len=128)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _random_lora_b(llm, seed):
    rs = np.random.RandomState(seed)
    llm = _np(llm)
    for path, x in tree_leaves_with_path(llm):
        if path.endswith("lora_b"):
            parent = llm
            for k in path.split("/")[:-1]:
                parent = parent[k]
            parent["lora_b"] = (rs.randn(*x.shape) * 0.05).astype(np.float32)
    return llm


def _fused(llm):
    """A LLaMA int8 tree with q|k|v and gate|up fused along the output."""
    layers = dict(llm["layers"])
    attn, mlp = dict(layers["attn"]), dict(layers["mlp"])
    cat = lambda ps, k: np.concatenate([p[k] for p in ps], -1)  # noqa: E731
    qkv = [attn.pop(n) for n in ("q", "k", "v")]
    gu = [mlp.pop(n) for n in ("gate", "up")]
    attn["qkv"] = {k: cat(qkv, k) for k in ("kernel", "scale")}
    mlp["gateup"] = {k: cat(gu, k) for k in ("kernel", "scale")}
    return {**llm, "layers": {**layers, "attn": attn, "mlp": mlp}}


def _rows(seed, vocab):
    """4 rows of unequal valid lengths, a frame each."""
    rs = np.random.RandomState(seed)
    rows = []
    for n in (9, 5, 13, 7):
        ids = [1] + rs.randint(3, vocab, n).tolist()
        ids[2] = IMG
        rows.append({"ids": ids, "labels": [-100] * 4 + ids[4:],
                     "frames": rs.randn(1, 3, 28, 28).astype(np.float32)})
    return rows


@pytest.fixture(scope="module")
def setup():
    base = dataclasses.replace(tiny_test_config(vocab_size=128), dtype="float32")
    llama_cfg = dataclasses.replace(base, llm=dataclasses.replace(base.llm, num_kv_heads=2))
    llama = _np(jax_teochat.init_teochat(jax.random.PRNGKey(11), llama_cfg))
    mpt_cfg = dataclasses.replace(base, llm=MptConfig(**MPT_KW), llm_backend="mpt")
    mpt = _np(jax_teochat.init_teochat(jax.random.PRNGKey(21), mpt_cfg))
    q8 = _np(jax_quant.quantize_llama_params(llama["llm"]))
    variants = {
        "llama_int8_lora": dict(
            cfg=llama_cfg, filter="lora", dtype="float32",
            params={**llama, "llm": _random_lora_b(
                jax_lora.add_lora_params(jax.random.PRNGKey(4), q8, rank=4, alpha=8.0), 4)}),
        "llama_bf16_full": dict(cfg=llama_cfg, filter="full", dtype="bfloat16", params=llama),
        "mpt_int8_lora": dict(
            cfg=mpt_cfg, filter="lora", dtype="float32",
            params={**mpt, "llm": _random_lora_b(jax_lora.add_lora_params(
                jax.random.PRNGKey(5), _np(jax_quant.quantize_mpt_params(mpt["llm"])),
                rank=4, alpha=8.0), 5)}),
    }
    rs = np.random.RandomState(0)
    mask = np.ones((2, 10), bool)
    mask[1, 7:] = False
    forward = {
        "llama_fused_int8": dict(cfg=llama_cfg, llm=_fused(q8)),
        "mpt_int8": dict(cfg=mpt_cfg, llm=_np(jax_quant.quantize_mpt_params(mpt["llm"]))),
    }
    for check in forward.values():
        check.update(embeds=rs.randn(2, 10, 64).astype(np.float32), mask=mask)
    batches = [_rows(s, 128) for s in range(3)]
    return dict(variants=variants, forward=forward, batches=batches,
                meshes=MESHES_4 + MESHES_2,
                checkpoint=dict(variant="mpt_int8_lora", save_mesh=(1, 2, 2),
                                load_mesh=(2, 1, 1)))


def _port_setup(setup):
    """The setup as the ranks read it: the port's config JSON, numpy trees."""
    def conv(d):
        return {**d, "cfg": TEOChatConfig.from_json(d["cfg"].to_json()).to_json(),
                **({"opt": OPT} if "filter" in d else {})}

    return {**setup, "variants": {k: conv(v) for k, v in setup["variants"].items()},
            "forward": {k: conv(v) for k, v in setup["forward"].items()}}


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """The 4-rank and 2-rank runs; their outputs' directory."""
    out = str(tmp_path_factory.mktemp("ranks"))
    port = _port_setup(setup)
    torch.save(port, os.path.join(out, "setup.pt"))
    # a one-process checkpoint of the checkpoint variant's 2 steps, for the
    # 2-rank mesh to load
    variant = port["variants"][setup["checkpoint"]["variant"]]
    state, _, _ = _torch_dist.run_steps(variant, port["batches"][:2])
    cfg = TEOChatConfig.from_json(variant["cfg"])
    orbax_io.save_checkpoint(os.path.join(out, "one_ckpt"), state.params, cfg,
                             opt_state=state.opt_state, step=2)
    torch.save({"params": {p: x.detach().numpy().copy()
                           for p, x in tree_leaves_with_path(state.params)},
                "opt": {p: x.numpy().copy() for p, x in tree_leaves_with_path(state.opt_state)
                        if isinstance(x, torch.Tensor)}},
               os.path.join(out, "one_saved.pt"))
    _torch_dist.launch(4, out, ["train", "save"])
    _torch_dist.launch(2, out, ["train", "load", "rounding"])
    return out


@pytest.fixture(scope="module")
def one_process(setup):
    """Each variant's 3 steps on one process: (losses, tree, squared norms)."""
    port = _port_setup(setup)
    out = {}
    for name, variant in port["variants"].items():
        record = {}
        state, losses, _ = _torch_dist.run_steps(variant, port["batches"], record=record)
        out[name] = (losses, {p: x.detach().float().numpy()
                              for p, x in tree_leaves_with_path(state.params)}, record)
    return out


# the tower's key bias: its exact gradient is zero (a bias added to every
# key leaves the softmax as it is), so each side steps it on rounding noise;
# held to Adam's bound, lr an update, as tests/test_torch_train_resume.py does
ZERO_GRADIENT = "vision/layers/attn/k/bias"


def _changes_agree(got, want, before, filt, tol, tree_tol=None):
    """Frozen leaves bitwise unchanged; each trained leaf's change within
    `tol` relative L2 of the reference's; with `tree_tol`, the trained
    leaves' changes together within it too."""
    assert sorted(got) == sorted(want)
    num = den = 0.0
    for path, b in before.items():
        b = np.asarray(b, np.float32)
        if filt is not None and not filt(path):
            np.testing.assert_array_equal(got[path], b, err_msg=path)
            continue
        dw, dg = want[path] - b, got[path] - b
        if path == ZERO_GRADIENT:
            assert max(np.abs(dw).max(), np.abs(dg).max()) <= 3 * 3 * OPT["learning_rate"]
            continue
        assert np.linalg.norm(dg - dw) <= tol * np.linalg.norm(dw) + 1e-12, (
            path, float(np.linalg.norm(dg - dw) / max(np.linalg.norm(dw), 1e-30)))
        num, den = num + float(np.sum((dg - dw) ** 2)), den + float(np.sum(dw ** 2))
    if tree_tol is not None:
        assert num <= tree_tol ** 2 * den, np.sqrt(num / den)


def _before(setup, name):
    return dict(tree_leaves_with_path(setup["variants"][name]["params"]))


@pytest.mark.parametrize("mesh", MESHES_4 + MESHES_2, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("name", ["llama_int8_lora", "llama_bf16_full", "mpt_int8_lora"])
def test_mesh_trains_like_one_process(setup, ranks, one_process, name, mesh):
    """Losses, the clip's global norm and every leaf after 3 steps on the
    mesh equal one process's on the whole batch: the loss's denominator is
    the global count of valid labels (the rows' counts differ), replicated
    leaves count once in the norm, fused wqkv runs each rank's heads."""
    got = torch.load(os.path.join(ranks, f"train_{name}_{''.join(map(str, mesh))}.pt"),
                     weights_only=False)
    losses, tree, record = one_process[name]
    tol = BF16 if setup["variants"][name]["dtype"] == "bfloat16" else FP32
    np.testing.assert_allclose(got["losses"], losses, rtol=tol["loss"])
    np.testing.assert_allclose(got["sq_norm"], record["sq_norm"], rtol=tol["loss"])
    _changes_agree(got["params"], tree, _before(setup, name),
                   _torch_dist.FILTERS[setup["variants"][name]["filter"]], tol["leaf"])


def _jax_steps(setup, name, mesh_shape):
    """JAX's train step over the same global batches, on a (2, 2, 2) mesh
    or one device: (losses, numpy tree)."""
    v = setup["variants"][name]
    cfg = v["cfg"]
    filt = _torch_dist.FILTERS[v["filter"]]
    optimizer = jax_trainer.make_optimizer(**OPT)
    params = jax.tree.map(jnp.asarray, v["params"])
    if mesh_shape is not None:
        params = jax_shard_params(params, jax_create_mesh(JaxMeshConfig(*mesh_shape)))
    state = jax.jit(lambda p: jax_trainer.init_train_state(p, optimizer, filt))(params)
    step = jax_trainer.make_train_step(cfg, optimizer, trainable_filter=filt, remat=True)
    losses = []
    for rows in setup["batches"]:
        plan = jax_fusion.build_fusion_plan(
            [r["ids"] for r in rows], labels=[r["labels"] for r in rows],
            tokens_per_frame=cfg.vision.num_patches)
        pixels = jnp.asarray(np.concatenate([r["frames"] for r in rows]), getattr(jnp, v["dtype"]))
        state, loss = step(state, plan, pixels)
        losses.append(float(loss))
    return losses, dict(tree_leaves_with_path(jax.tree.map(
        lambda x: np.asarray(x, np.float32), state.params)))


@pytest.mark.parametrize("name", ["llama_int8_lora", "llama_bf16_full", "mpt_int8_lora"])
def test_one_process_and_mesh_match_jax(setup, ranks, one_process, name):
    """The one-process port and the (1, 2, 2) mesh against JAX's GSPMD step
    on its (2, 2, 2) mesh and on one device."""
    bf16 = setup["variants"][name]["dtype"] == "bfloat16"
    loss_tol, leaf_tol, tree_tol = ((BF16["loss"], JAX_BF16_LEAF, BF16["leaf"]) if bf16
                                    else (FP32["loss"], JAX_LEAF, None))
    filt = _torch_dist.FILTERS[setup["variants"][name]["filter"]]
    mesh = torch.load(os.path.join(ranks, f"train_{name}_122.pt"), weights_only=False)
    for shape in ((2, 2, 2), None):
        jlosses, jtree = _jax_steps(setup, name, shape)
        for losses, tree in ((one_process[name][0], one_process[name][1]),
                             (mesh["losses"], mesh["params"])):
            np.testing.assert_allclose(losses, jlosses, rtol=loss_tol)
            _changes_agree(tree, jtree, _before(setup, name), filt, leaf_tol, tree_tol)


@pytest.mark.parametrize("mesh", MESHES_4 + MESHES_2, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("name", ["llama_fused_int8", "mpt_int8"])
def test_sharded_logits_match_one_device(setup, ranks, name, mesh):
    """A fused int8 q|k|v / gate|up (and MPT's wqkv, with each rank's ALiBi
    slopes) laid out per rank gives the one-device logits."""
    check = _port_setup(setup)["forward"][name]
    cfg = TEOChatConfig.from_json(check["cfg"])
    llm = to_torch(check["llm"], "cpu")
    embeds, mask = torch.from_numpy(check["embeds"]), torch.from_numpy(check["mask"])
    with torch.no_grad():
        if torch_mpt.is_mpt_params(llm):
            want = torch_mpt.mpt_forward(llm, cfg.llm, embeds, attention_mask=mask,
                                         right_padded=True)
        else:
            pos = torch.arange(10)[None].expand(2, -1)
            want = torch_llama.llama_forward(llm, cfg.llm, embeds, position_ids=pos,
                                             attention_mask=mask, right_padded=True)
    got = torch.load(os.path.join(ranks, f"logits_{name}_{''.join(map(str, mesh))}.pt"),
                     weights_only=False)
    want = want.numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_checkpoint_saved_on_one_mesh_loads_on_others(setup, ranks):
    """Saved on (1, 2, 2): pruned to the newest, the final save drops the
    optimizer state (F7); loaded on one process (without and with
    templates) and on (2, 1, 1), every leaf and moment bitwise the saved
    trees; the (2, 1, 1) resume's step equals the one process's third. A
    one-process checkpoint loads on (2, 1, 1) bitwise too."""
    saved = torch.load(os.path.join(ranks, "saved.pt"), weights_only=False)
    loaded = torch.load(os.path.join(ranks, "loaded.pt"), weights_only=False)
    ckpt = os.path.join(ranks, "ckpt")
    assert sorted(os.listdir(ckpt)) == ["checkpoint-2"]
    assert loaded["from"] == os.path.join(ckpt, "checkpoint-2")
    final = os.path.join(ranks, "ckpt_final", "checkpoint-2")
    assert not os.path.exists(os.path.join(final, "opt_state"))
    one = torch.load(os.path.join(ranks, "one_saved.pt"), weights_only=False)
    for got, want in ((loaded, saved), (loaded["from_one"], one)):
        for part in ("params", "opt"):
            assert sorted(got[part]) == sorted(want[part])
            for path, x in want[part].items():
                np.testing.assert_array_equal(got[part][path], x.astype(np.float32),
                                              err_msg=path)
    params, cfg, opt = orbax_io.load_checkpoint(os.path.join(ckpt, "checkpoint-2"),
                                                restore_opt=True)
    assert cfg.llm_backend == "mpt"
    for path, x in tree_leaves_with_path(params):
        np.testing.assert_array_equal(x.float().numpy(), saved["params"][path], err_msg=path)
    for path, x in tree_leaves_with_path(opt):
        if isinstance(x, torch.Tensor):
            np.testing.assert_array_equal(x.numpy(), saved["opt"][path], err_msg=path)
    # one process, with templates, then resumed: the same third step
    variant = _port_setup(setup)["variants"]["mpt_int8_lora"]
    state, losses, _ = _torch_dist.run_steps(variant, setup["batches"])
    np.testing.assert_allclose(saved["losses"] + loaded["losses"], losses, rtol=FP32["loss"])
    _changes_agree(loaded["resume"], {p: x.detach().float().numpy()
                                      for p, x in tree_leaves_with_path(state.params)},
                   _before(setup, "mpt_int8_lora"), _torch_dist.FILTERS["lora"], FP32["leaf"])


def test_row_parallel_products_round_once(ranks):
    """F2 / F2b on the mesh: a row-parallel int8 projection (alone and with
    LoRA's x A summed before B) and a bf16 one, in bf16 on (1, 1, 2), sum
    their fp32 partials over `model` before one rounding, so at least 99 %
    of the outputs are one device's bits (the sums differ only in order);
    rounding each rank's part first would agree on far fewer."""
    shares = torch.load(os.path.join(ranks, "rounding.pt"), weights_only=False)
    assert sorted(shares) == ["bf16", "int8", "int8_lora"]
    for name, share in shares.items():
        assert share >= 0.99, (name, share)


def test_per_rank_batch_streams_match_jax():
    """_batches with process_index / process_count: the chunks ≡ p (mod
    count) of the sampler's stream, as JAX's (tests/test_train_loop.py),
    and together every chunk once."""
    dataset = list(range(24))
    for count in (1, 2, 4):
        taken = []
        for p in range(count):
            want = list(jax_train_mod._batches(dataset, tuple, iter(range(24)), 3,
                                               process_index=p, process_count=count))
            got = list(torch_train_mod._batches(dataset, tuple, iter(range(24)), 3,
                                                process_index=p, process_count=count))
            assert got == want
            taken += [i for b in got for i in b]
        assert sorted(taken) == dataset
