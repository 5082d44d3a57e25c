"""The port's MPT init-scheme registry (models/mpt_init.py) and random MPT
decoders (models/mpt.py::init_mpt, checkpoint/bridge.py::init_mpt) against
the JAX package's.

The draws are torch's, so the trees are compared by structure, shape and
dtype, and each scheme by the statistics JAX's tests/test_mpt_init.py reads
(std within 5 % of the scheme's, uniform bounds, the residual division, the
fused q|k|v's per-split fans); unknown schemes and bad settings raise as in
JAX.
"""

import math

import numpy as np
import pytest
import torch

import jax

from teochat_tpu.config import MptConfig
from teochat_tpu.models import mpt as jax_mpt
from teochat_tpu.models import mpt_init as jax_mpt_init
from teochat_torch.checkpoint.bridge import init_mpt as bridge_init_mpt
from teochat_torch.checkpoint.bridge import init_teochat, to_numpy
from teochat_torch.config import MptConfig as TorchMptConfig
from teochat_torch.config import TEOChatConfig
from teochat_torch.models import mpt as torch_mpt
from teochat_torch.models import mpt_init as torch_mpt_init
from teochat_torch.ops import quant as torch_quant

STD_RTOL = 0.05


def _cfgs(**over):
    kw = dict(vocab_size=128, d_model=64, n_layers=3, n_heads=4, expansion_ratio=2,
              max_seq_len=64)
    kw.update(over)
    return MptConfig(**kw), TorchMptConfig(**kw)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _layout(tree):
    """{path: (shape, dtype)} of a numpy view of a tree."""
    return {"/".join(str(getattr(k, "key", k)) for k in path): (a.shape, a.dtype)
            for path, a in jax.tree_util.tree_leaves_with_path(tree)}


def _f64(t):
    return t.double().numpy()


@pytest.mark.parametrize("name", list(torch_mpt_init.MODEL_INIT_REGISTRY) + [None])
@pytest.mark.parametrize("no_bias,attn", [(True, "multihead_attention"),
                                          (False, "multiquery_attention")])
def test_tree_layout_matches_jax(name, no_bias, attn):
    """Every scheme (None: init_mpt's plain N(0, 0.02)) gives JAX's tree:
    the same paths, shapes and dtypes, norms ones and biases zeros but
    under default_."""
    init_config = None if name is None else {"name": name, "init_std": 0.02}
    jcfg, tcfg = _cfgs(no_bias=no_bias, attn_type=attn, init_config=init_config)
    want = jax.tree.map(np.asarray, jax_mpt.init_mpt(jax.random.PRNGKey(0), jcfg))
    got = to_numpy(torch_mpt.init_mpt(_gen(), tcfg, device="cpu"))
    assert _layout(got) == _layout(want)
    assert np.all(got["layers"]["norm1"]["scale"] == 1) and np.all(got["final_norm"]["scale"] == 1)
    if not no_bias and name != "default_":
        assert not got["layers"]["wqkv"]["bias"].any()


def test_kaiming_normal_residual_division():
    """kaiming_normal (relu): std sqrt(2 / fan_in); the residual projections
    divided by sqrt(2 n_layers)."""
    _, cfg = _cfgs(n_layers=8, d_model=256, n_heads=8)
    p = torch_mpt_init.init_mpt_params(_gen(1), cfg, device="cpu")
    up, out = _f64(p["layers"]["up_proj"]["kernel"]), _f64(p["layers"]["out_proj"]["kernel"])
    std = math.sqrt(2.0 / cfg.d_model)
    assert abs(up.std() - std) / std < STD_RTOL
    assert abs(out.std() - std / math.sqrt(2 * cfg.n_layers)) / std < STD_RTOL


def test_baseline_needs_init_std_and_neox_divides():
    _, cfg = _cfgs(d_model=256, n_layers=10)
    with pytest.raises(ValueError, match="init_std"):
        torch_mpt_init.init_mpt_params(_gen(), cfg, init_config={"name": "baseline_"},
                                       device="cpu")
    p = torch_mpt_init.init_mpt_params(
        _gen(), cfg, init_config={"name": "baseline_", "init_std": 0.03,
                                  "init_div_is_residual": False}, device="cpu")
    assert abs(_f64(p["layers"]["up_proj"]["kernel"]).std() - 0.03) / 0.03 < STD_RTOL
    p = torch_mpt_init.init_mpt_params(_gen(2), cfg, init_config={"name": "neox_init_"},
                                       device="cpu")
    std = math.sqrt(2 / (5 * cfg.d_model))
    want_out = std / (cfg.n_layers / math.sqrt(10))
    assert abs(_f64(p["layers"]["up_proj"]["kernel"]).std() - std) / std < STD_RTOL
    assert abs(_f64(p["layers"]["out_proj"]["kernel"]).std() - want_out) / want_out < STD_RTOL


def test_embedding_overrides():
    _, cfg = _cfgs(vocab_size=512, d_model=128)
    p = torch_mpt_init.init_mpt_params(
        _gen(3), cfg, init_config={"name": "small_init_", "emb_init_std": 0.5}, device="cpu")
    assert abs(_f64(p["wte"]["embedding"]).std() - 0.5) / 0.5 < STD_RTOL
    p = torch_mpt_init.init_mpt_params(
        _gen(4), cfg, init_config={"name": "small_init_", "emb_init_uniform_lim": 0.2},
        device="cpu")
    e = _f64(p["wte"]["embedding"])
    assert e.min() >= -0.2 and e.max() <= 0.2 and abs(e.std() - 0.2 / math.sqrt(3)) < 0.02
    p = torch_mpt_init.init_mpt_params(
        _gen(4), cfg, init_config={"name": "small_init_", "emb_init_uniform_lim": [0.1, 0.3]},
        device="cpu")
    e = _f64(p["wte"]["embedding"])
    assert e.min() >= 0.1 and e.max() <= 0.3
    with pytest.raises(ValueError, match="min and a max"):
        torch_mpt_init.init_mpt_params(
            _gen(5), cfg, init_config={"name": "small_init_",
                                       "emb_init_uniform_lim": (0.1, 0.2, 0.3)}, device="cpu")


def test_default_scheme_is_torch_module_defaults():
    """default_: N(0, 1) embedding, kaiming_uniform a = sqrt(5) linears
    (bound 1 / sqrt(fan_in)), biases U(-bound, bound), no residual division."""
    _, cfg = _cfgs(d_model=256, no_bias=False)
    p = torch_mpt_init.init_mpt_params(_gen(6), cfg, init_config={"name": "default_"},
                                       device="cpu")
    assert abs(_f64(p["wte"]["embedding"]).std() - 1.0) < 0.05
    up, out = _f64(p["layers"]["up_proj"]["kernel"]), _f64(p["layers"]["out_proj"]["kernel"])
    bound = 1.0 / math.sqrt(cfg.d_model)
    assert up.max() <= bound + 1e-9 and up.min() >= -bound - 1e-9
    assert abs(out.std() - up.std()) / up.std() < STD_RTOL
    bias = _f64(p["layers"]["up_proj"]["bias"])
    assert np.abs(bias).max() <= bound and bias.std() > 0


def test_fused_wqkv_per_split_fans():
    """Multiquery q|k|v under xavier_uniform: the q split (width d) and the
    k / v splits (width head_dim) each take their own bound."""
    _, cfg = _cfgs(d_model=128, n_heads=8, attn_type="multiquery_attention")
    p = torch_mpt_init.init_mpt_params(
        _gen(7), cfg, init_config={"name": "xavier_uniform_", "init_gain": 1.0}, device="cpu")
    w = _f64(p["layers"]["wqkv"]["kernel"])
    d, hd = cfg.d_model, cfg.d_model // cfg.n_heads
    q, kv = w[..., :d], w[..., d:]
    for part, bound in ((q, math.sqrt(6.0 / (d + d))), (kv, math.sqrt(6.0 / (d + hd)))):
        assert abs(np.abs(part).max() - bound) / bound < STD_RTOL


@pytest.mark.parametrize("init_config", [{"name": "made_up_"}, {"name": None},
                                         {"name": "small_init_",
                                          "init_div_is_residual": "not-a-number"},
                                         {"name": "kaiming_normal_",
                                          "init_nonlinearity": "swish"}])
def test_unknown_schemes_and_settings_raise_as_in_jax(init_config):
    jcfg, tcfg = _cfgs()
    with pytest.raises(ValueError):
        jax_mpt_init.init_mpt_params(jax.random.PRNGKey(0), jcfg, init_config=init_config)
    with pytest.raises(ValueError):
        torch_mpt_init.init_mpt_params(_gen(), tcfg, init_config=init_config, device="cpu")


def test_bridge_draws_an_int8_decoder_and_a_llava_mpt():
    """bridge.init_mpt(quant='int8') gives quantize_mpt_params' layout (int8
    kernels, fp32 scales, biases kept), runs a forward, and init_teochat
    takes an MptConfig; int4 is refused."""
    _, cfg = _cfgs(no_bias=False)
    p = bridge_init_mpt(cfg, _gen(), "cpu", torch.float32)
    ref = torch_quant.quantize_mpt_params(bridge_init_mpt(cfg, _gen(), "cpu", torch.float32,
                                                          quant=None))
    assert _layout(to_numpy(p)) == _layout(to_numpy(ref))
    assert p["layers"]["wqkv"]["kernel"].dtype == torch.int8
    logits = torch_mpt.mpt_forward(p, cfg, torch_mpt.mpt_embed(p, torch.tensor([[1, 2, 3]])))
    assert logits.shape == (1, 3, cfg.vocab_size) and torch.isfinite(logits).all()
    with pytest.raises(NotImplementedError, match="int4"):
        bridge_init_mpt(cfg, _gen(), "cpu", quant="int4")
    from teochat_torch.config import ProjectorConfig, VisionConfig

    tiny = TEOChatConfig(vision=VisionConfig(image_size=28, patch_size=14, hidden_size=32,
                                             intermediate_size=64, num_layers=2, num_heads=4),
                         projector=ProjectorConfig(mm_hidden_size=32, hidden_size=cfg.d_model),
                         llm=cfg, llm_backend="mpt")
    params = init_teochat(tiny, _gen(), "cpu", torch.float32)
    assert "wte" in params["llm"] and params["llm"]["layers"]["up_proj"]["kernel"].dtype == \
        torch.int8
