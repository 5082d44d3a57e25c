"""MPT from-scratch parameter-init registry (port of teochat_tpu/models/mpt_init.py).

Reference: videollava/model/language_model/mpt/param_init_fns.py
(MODEL_INIT_REGISTRY, generic_param_init_fn_, fused_init_helper_) and
configuration_mpt.py (init_config_defaults). Each scheme resolves to an
``init_fn(shape, fan_in, fan_out) -> tensor`` drawn from one
`torch.Generator`, and ``init_mpt_params`` builds the stacked-per-layer
tree of ``mpt.init_mpt``. The draws are torch's, not JAX's: the schemes'
distributions (std, bounds, fans) are the same.

Semantics carried over exactly:
- residual projections (attn ``out_proj``, mlp ``down_proj``) are divided
  by ``init_div_is_residual`` (True -> sqrt(2 n_layers), numeric -> itself,
  False -> 1.0);
- the fused Wqkv kernel is drawn per Q / K / V split, each with its own fan;
- the embedding uses ``emb_init_std`` (normal), else ``emb_init_uniform_lim``
  (uniform; a scalar limit is symmetric), else the linear scheme with
  torch's (num_embeddings, dim) fan convention;
- norm scales are ones and biases zeros, except under ``default_``, which
  reproduces torch's module defaults (kaiming_uniform a=sqrt(5) on the whole
  weight, bias ~ U(-1/sqrt(fan_in), +), embedding ~ N(0, 1)) and applies no
  residual division.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch

from teochat_torch.utils import resolve_device

# configuration_mpt.py: merged under user-provided keys
INIT_CONFIG_DEFAULTS: Dict[str, Any] = {
    "name": "kaiming_normal_",
    "fan_mode": "fan_in",
    "init_nonlinearity": "relu",
    "init_div_is_residual": True,
    "emb_init_std": None,
    "emb_init_uniform_lim": None,
    "init_std": None,
    "init_gain": 0.0,
}

MODEL_INIT_REGISTRY = (
    "default_", "baseline_", "kaiming_uniform_", "kaiming_normal_",
    "neox_init_", "small_init_", "xavier_uniform_", "xavier_normal_",
)

InitFn = Callable[[tuple, int, int], torch.Tensor]


def _calculate_gain(nonlinearity: str, a: float = 0.0) -> float:
    """torch.nn.init.calculate_gain, the subset the kaiming schemes use."""
    linear_fns = (
        "linear", "conv1d", "conv2d", "conv3d",
        "conv_transpose1d", "conv_transpose2d", "conv_transpose3d", "sigmoid",
    )
    if nonlinearity in linear_fns:
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        return math.sqrt(2.0 / (1 + a * a))
    raise ValueError(f"Unsupported nonlinearity {nonlinearity}")


class _Draw:
    """Normal and uniform tensors from one generator on one device."""

    def __init__(self, generator: torch.Generator, device):
        self.gen, self.device = generator, device

    def normal(self, shape, std: float) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device) * std

    def uniform(self, shape, lo: float, hi: float) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.device) * (hi - lo) + lo


def _resolve_div_is_residual(val, n_layers: int) -> float:
    """param_init_fns.py's init_div_is_residual (numeric strings included)."""
    if val is False:
        return 1.0
    if val is True:
        return math.sqrt(2 * n_layers)
    if isinstance(val, (int, float)):
        return float(val)
    if isinstance(val, str) and val.isnumeric():
        return float(val)
    raise ValueError(f"Expected init_div_is_residual to be boolean or numeric, got {val}")


def _linear_scheme(draw: _Draw, name: str, ic: Dict[str, Any], d_model: int) -> InitFn:
    """The linear init of a named scheme; raises on a missing init_std."""
    gain = float(ic.get("init_gain", 0.0))
    fan_mode = ic.get("fan_mode", "fan_in")
    nonlin = ic.get("init_nonlinearity", "relu")

    def fan(fan_in, fan_out):
        return fan_in if fan_mode == "fan_in" else fan_out

    if name == "baseline_":
        if ic.get("init_std") is None:
            raise ValueError(
                "You must set model.init_config['init_std'] to a float value "
                "to use the default initialization scheme."
            )
        return lambda shape, fi, fo: draw.normal(shape, float(ic["init_std"]))
    if name in ("small_init_", "neox_init_"):
        return lambda shape, fi, fo: draw.normal(shape, math.sqrt(2 / (5 * d_model)))
    if name == "kaiming_uniform_":
        g = _calculate_gain(nonlin, gain)
        return lambda shape, fi, fo: _sym_uniform(draw, shape, g * math.sqrt(3.0 / fan(fi, fo)))
    if name == "kaiming_normal_":
        g = _calculate_gain(nonlin, gain)
        return lambda shape, fi, fo: draw.normal(shape, g / math.sqrt(fan(fi, fo)))
    if name == "xavier_uniform_":
        return lambda shape, fi, fo: _sym_uniform(draw, shape, gain * math.sqrt(6.0 / (fi + fo)))
    if name == "xavier_normal_":
        return lambda shape, fi, fo: draw.normal(shape, gain * math.sqrt(2.0 / (fi + fo)))
    raise ValueError(f"Initialization scheme {name} not found in registry.")


def _sym_uniform(draw: _Draw, shape, bound: float) -> torch.Tensor:
    return draw.uniform(shape, -bound, bound)


def init_mpt_params(generator: torch.Generator, cfg, dtype: torch.dtype = torch.float32,
                    init_config: Optional[dict] = None, device=None) -> dict:
    """MPT params under a named init scheme (the stacked-layer tree of
    ``mpt.init_mpt``) on `device` (None = the card). ``init_config`` keys
    follow the reference's configuration_mpt.py defaults."""
    ic = dict(INIT_CONFIG_DEFAULTS)
    ic.update(init_config or getattr(cfg, "init_config", None) or {})
    name = ic.get("name")
    if name is None:
        raise ValueError(f"init_config={ic!r} 'name' needs to be set.")
    if name not in MODEL_INIT_REGISTRY:
        raise ValueError(f"Initialization scheme {name} not found in registry.")
    draw = _Draw(generator, resolve_device(device))

    d, L = cfg.d_model, cfg.n_layers
    hd = d // cfg.n_heads
    n_kv = 1 if cfg.attn_type == "multiquery_attention" else cfg.n_heads
    ffn = cfg.expansion_ratio * d

    if name == "default_":
        # torch module defaults: Linear.reset_parameters is kaiming_uniform
        # (a = sqrt(5)) over the WHOLE weight (no fused split, no residual
        # division); Embedding is N(0, 1)
        g = _calculate_gain("leaky_relu", math.sqrt(5.0))

        def lin_fn(shape, fi, fo):
            return _sym_uniform(draw, shape, g * math.sqrt(3.0 / fi))

        def emb_fn(shape, fi, fo):
            return draw.normal(shape, 1.0)

        div = 1.0
    else:
        lin_fn = _linear_scheme(draw, name, ic, d)
        div = _resolve_div_is_residual(ic.get("init_div_is_residual", True), L)
        if name == "neox_init_":  # small_init with its own residual division
            div = L / math.sqrt(10)
        emb_std, emb_lim = ic.get("emb_init_std"), ic.get("emb_init_uniform_lim")
        if emb_std is not None:
            def emb_fn(shape, fi, fo):
                return draw.normal(shape, float(emb_std))
        elif emb_lim is not None:
            if isinstance(emb_lim, (list, tuple)):
                if len(emb_lim) > 2:
                    raise ValueError(
                        f"Uniform init requires a min and a max limit. User input: {emb_lim}.")
                lo, hi = float(emb_lim[0]), float(emb_lim[1])
            else:
                lo, hi = -float(emb_lim), float(emb_lim)

            def emb_fn(shape, fi, fo):
                return draw.uniform(shape, lo, hi)
        else:
            emb_fn = lin_fn

    def dense(fan_in, fan_out, is_residual=False, fused_splits=None):
        if fused_splits and name != "default_":
            # each split of the fused kernel with its own fan
            bounds = (0, *fused_splits, fan_out)
            w = torch.cat([lin_fn((L, fan_in, e - s), fan_in, e - s)
                           for s, e in zip(bounds[:-1], bounds[1:])], dim=-1)
        else:
            w = lin_fn((L, fan_in, fan_out), fan_in, fan_out)
        if is_residual:
            w = w / div
        p = {"kernel": w.to(dtype)}
        if not cfg.no_bias:
            if name == "default_":
                bound = 1.0 / math.sqrt(fan_in)
                p["bias"] = _sym_uniform(draw, (L, fan_out), bound).to(dtype)
            else:
                p["bias"] = torch.zeros((L, fan_out), dtype=dtype, device=draw.device)
        return p

    def ln(shape):
        p = {"scale": torch.ones(shape, dtype=torch.float32, device=draw.device)}
        if not cfg.no_bias:
            p["bias"] = torch.zeros(shape, dtype=torch.float32, device=draw.device)
        return p

    # torch's Embedding weight is (num_embeddings, dim): fan_in = dim
    emb = emb_fn((cfg.vocab_size, d), d, cfg.vocab_size)
    return {
        "wte": {"embedding": emb.to(dtype)},
        "layers": {
            "norm1": ln((L, d)),
            "wqkv": dense(d, d + 2 * n_kv * hd, fused_splits=(d, d + n_kv * hd)),
            "out_proj": dense(d, d, is_residual=True),
            "norm2": ln((L, d)),
            "up_proj": dense(d, ffn),
            "down_proj": dense(ffn, d, is_residual=True),
        },
        "final_norm": ln((d,)),
    }
