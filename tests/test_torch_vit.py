"""The port's vision tower and projector against the JAX package, on CPU.

Same weights (the JAX init, bridged through numpy) and the same seeded
frames go through both; fp32, compared to 1e-4 relative.
"""

import numpy as np
import pytest
import torch

import jax

from teochat_tpu.config import tiny_test_config
from teochat_tpu.models import teochat as jax_teochat
from teochat_tpu.models import vit as jax_vit
from teochat_torch.checkpoint.bridge import to_torch
from teochat_torch.models import teochat as torch_teochat
from teochat_torch.models import vit as torch_vit
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "time_attn"])
def setup(request):
    cfg = tiny_test_config(add_time_attn=request.param)
    params = jax_teochat.init_teochat(jax.random.PRNGKey(1), cfg)
    frames = np.random.RandomState(2).randn(4, 3, 28, 28).astype(np.float32)
    return cfg, params, to_torch(jax.tree.map(np.asarray, params), "cpu"), frames


def test_vit_hidden_states_match_jax(setup):
    cfg, params, tparams, frames = setup
    num_frames = 2 if cfg.vision.add_time_attn else 1
    for select_layer in (-2, -1):
        want = jax_vit.vit_forward(params["vision"], cfg.vision, frames,
                                   select_layer=select_layer, num_frames=num_frames)
        got = torch_vit.vit_forward(tparams["vision"], cfg.vision, torch.from_numpy(frames),
                                    select_layer=select_layer, num_frames=num_frames)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_encode_frames_match_jax(setup):
    cfg, params, tparams, frames = setup
    want = jax_teochat.encode_frames(params, cfg, frames)
    got = torch_teochat.encode_frames(tparams, cfg, torch.from_numpy(frames))
    assert got.shape == (4, cfg.vision.num_patches, cfg.llm.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
