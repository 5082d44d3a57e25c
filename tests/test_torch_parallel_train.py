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
# the sequence and pipe meshes (data, fsdp, model, sequence, pipe), each
# with its microbatch count (None: the stage count) and variants; plans
# padded to a length the sequence axis divides, as the collator's buckets
LORA, FULL, MPT = "llama4_int8_lora", "llama4_bf16_full", "mpt_int8_lora"
CP_RUNS = [((1, 1, 1, 2, 1), None, [LORA, FULL]), ((1, 2, 1, 2, 1), None, [LORA, FULL]),
           ((1, 1, 1, 1, 2), None, [LORA, FULL, MPT]), ((1, 1, 1, 1, 2), 4, [LORA]),
           ((1, 2, 1, 1, 2), None, [LORA, FULL])]
PAD_TO = 20
# each trained leaf's first gradient on a sequence / pipe mesh against one
# process's: fp32 the same sums in another order; bf16 as the leaves' bound
GRAD = dict(float32=1e-4, bfloat16=1.5e-1)


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
    # 4 layers, which a pipe axis of 2 divides, for the sequence / pipe runs
    cfg4 = dataclasses.replace(llama_cfg, llm=dataclasses.replace(llama_cfg.llm, num_layers=4))
    llama4 = _np(jax_teochat.init_teochat(jax.random.PRNGKey(12), cfg4))
    cp_variants = {
        LORA: dict(cfg=cfg4, filter="lora", dtype="float32", params={
            **llama4, "llm": _random_lora_b(jax_lora.add_lora_params(
                jax.random.PRNGKey(6), _np(jax_quant.quantize_llama_params(llama4["llm"])),
                rank=4, alpha=8.0), 6)}),
        FULL: dict(cfg=cfg4, filter="full", dtype="bfloat16", params=llama4),
        MPT: variants[MPT],
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
                                load_mesh=(2, 1, 1)),
                cp_variants=cp_variants, cp_runs=CP_RUNS, pad_to=PAD_TO)


def _port_setup(setup):
    """The setup as the ranks read it: the port's config JSON, numpy trees."""
    def conv(d):
        return {**d, "cfg": TEOChatConfig.from_json(d["cfg"].to_json()).to_json(),
                **({"opt": OPT} if "filter" in d else {})}

    return {**setup, "variants": {k: conv(v) for k, v in setup["variants"].items()},
            "cp_variants": {k: conv(v) for k, v in setup["cp_variants"].items()},
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
    _torch_dist.launch(4, out, ["train", "save", "context_pipe"])
    _torch_dist.launch(2, out, ["train", "load", "rounding", "context_pipe"])
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


def _before(setup, name, key="variants"):
    return dict(tree_leaves_with_path(setup[key][name]["params"]))


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


# ------------------------------------------------------------ sequence and pipe


@pytest.fixture(scope="module")
def one_process_padded(setup):
    """The sequence / pipe runs' variants on one process, plans padded alike:
    (losses, tree, record with the first step's gradients)."""
    port = _port_setup(setup)
    out = {}
    for name in (LORA, FULL, MPT):
        record = {}
        state, losses, _ = _torch_dist.run_steps(port["cp_variants"][name], port["batches"],
                                                 record=record, pad_to=PAD_TO)
        out[name] = (losses, {p: x.detach().float().numpy()
                              for p, x in tree_leaves_with_path(state.params)}, record)
    return out


def _cp_tag(shape, mb):
    return "".join(map(str, shape)) + f"_m{mb}"


CP_CASES = [(shape, mb, name) for shape, mb, names in CP_RUNS for name in names]


@pytest.mark.parametrize("shape,mb,name", CP_CASES,
                         ids=[f"{_cp_tag(s, m)}-{n}" for s, m, n in CP_CASES])
def test_sequence_and_pipe_meshes_train_like_one_process(setup, ranks, one_process_padded,
                                                         shape, mb, name):
    """3 steps on a sequence mesh (the ring: each rank its chunk of every
    row, labels shifted on the whole row) or a pipe mesh (GPipe stages)
    equal one process's: the losses, the clip's global norm, every trained
    leaf's first gradient (full fine-tuning trains the embedding, the
    lm_head and the tower, which feed or follow the pipeline), and the
    leaves after the steps; frozen leaves bitwise."""
    got = torch.load(os.path.join(ranks, f"cp_{name}_{_cp_tag(shape, mb)}.pt"),
                     weights_only=False)
    losses, tree, record = one_process_padded[name]
    dtype = setup["cp_variants"][name]["dtype"]
    tol = BF16 if dtype == "bfloat16" else FP32
    np.testing.assert_allclose(got["losses"], losses, rtol=tol["loss"])
    np.testing.assert_allclose(got["sq_norm"], record["sq_norm"], rtol=tol["loss"])
    assert sorted(got["grads"]) == sorted(record["grads"])
    for path, want in record["grads"].items():
        if path == ZERO_GRADIENT:  # rounding noise on both sides
            continue
        err = np.linalg.norm(got["grads"][path] - want)
        assert err <= GRAD[dtype] * np.linalg.norm(want) + 1e-12, (
            path, float(err / max(np.linalg.norm(want), 1e-30)))
    _changes_agree(got["params"], tree, _before(setup, name, "cp_variants"),
                   _torch_dist.FILTERS[setup["cp_variants"][name]["filter"]], tol["leaf"])


def test_sequence_mesh_loss_matches_jax(setup, ranks, one_process_padded):
    """JAX's train step with `sequence_axis` on its (1, 2, 1, sequence 4)
    mesh (tests/test_ring_attention.py's check, loss within 2e-3) against
    the port's first loss on one process and on (1, 2, 1, sequence 2)."""
    v = setup["cp_variants"][LORA]
    cfg = v["cfg"]
    seq_cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, sequence_axis="sequence"))
    filt = _torch_dist.FILTERS[v["filter"]]
    optimizer = jax_trainer.make_optimizer(**OPT)
    rows = setup["batches"][0]
    plan = jax_fusion.build_fusion_plan(
        [r["ids"] for r in rows], labels=[r["labels"] for r in rows],
        tokens_per_frame=cfg.vision.num_patches, pad_to=PAD_TO)
    pixels = jnp.asarray(np.concatenate([r["frames"] for r in rows]))
    mesh = jax_create_mesh(JaxMeshConfig(data=1, fsdp=2, model=1, sequence=4))
    with jax.set_mesh(mesh):
        params = jax_shard_params(jax.tree.map(jnp.asarray, v["params"]), mesh)
        state = jax.jit(lambda p: jax_trainer.init_train_state(p, optimizer, filt))(params)
        step = jax_trainer.make_train_step(seq_cfg, optimizer, trainable_filter=filt, remat=True)
        _, loss = step(state, plan, pixels)
    mesh_run = torch.load(os.path.join(ranks, f"cp_{LORA}_{_cp_tag((1, 2, 1, 2, 1), None)}.pt"),
                          weights_only=False)
    for losses in (one_process_padded[LORA][0], mesh_run["losses"]):
        assert abs(losses[0] - float(loss)) < 2e-3, (losses[0], float(loss))


@pytest.mark.parametrize("shape", [(1, 1, 1, 1, 2), (1, 2, 1, 1, 2)],
                         ids=lambda s: "".join(map(str, s)))
def test_pipe_checkpoint_loads_on_one_process(ranks, shape):
    """A checkpoint saved on a pipe mesh (each stage writes its layers)
    loads on one process: every leaf bitwise the run's gathered tree, the
    optimizer state whole, and the saved config without `pipeline_axis` or
    `sequence_axis` (the run's switches are never persisted)."""
    tag = _cp_tag(shape, None)
    params, cfg, opt = orbax_io.load_checkpoint(
        os.path.join(ranks, f"ckpt_{LORA}_{tag}", "checkpoint-3"), restore_opt=True)
    want = torch.load(os.path.join(ranks, f"cp_{LORA}_{tag}.pt"), weights_only=False)["params"]
    got = dict(tree_leaves_with_path(params))
    assert sorted(got) == sorted(want)
    for path, x in got.items():
        np.testing.assert_array_equal(x.float().numpy(), want[path], err_msg=path)
    assert cfg.llm.pipeline_axis is None and cfg.llm.sequence_axis is None
    assert opt["inner"]["mu"] if "inner" in opt else opt["mu"]
