"""The port's tower facade (teochat_torch/models/towers.py) for every tower
name, against the JAX package on the CPU in fp32.

Each name gives JAX's config (the video tower's temporal attention, the
audio tower's rectangular 126 x 1036 geometry: 9 x 74 patches plus CLS =
667 tokens, inside K5's gate) and, at a tiny width on JAX's weights carried
over by the bridge (temporal leaves and a rectangular position table
included, round trip exact), JAX's features within FWD_RTOL of the largest
|feature| (the same fp32 arithmetic summed in other orders; read ~1e-6).
The random init builds JAX's tree for each; `resize_position_embedding`
follows `jax.image.resize`'s bicubic within 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from teochat_tpu.config import VisionConfig
from teochat_tpu.models import towers as jax_towers
from teochat_tpu.models import vit as jax_vit
from teochat_torch.checkpoint.bridge import to_numpy, to_torch
from teochat_torch.config import VisionConfig as TorchVisionConfig
from teochat_torch.models import towers as torch_towers
from teochat_torch.models import vit as torch_vit
from teochat_torch.utils import tree_leaves_with_path
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

FWD_RTOL = 1e-5
TINY = dict(image_size=28, patch_size=14, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=4, num_frames=4)
NAMES = {  # name: the tiny geometry's kwargs for build_vision_tower
    "LanguageBind/LanguageBind_Image": {},
    "LanguageBind/LanguageBind_Video_merge": {},
    "LanguageBind/LanguageBind_Audio": dict(num_mel_bins=14, target_length=42),
    "LanguageBind/LanguageBind_Depth": {},
    "LanguageBind/LanguageBind_Thermal": {},
    "openai/clip-vit-large-patch14": {},
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("name", list(NAMES))
def test_tower_config_and_forward_match_jax(name):
    full_t, full_j = torch_towers.build_vision_tower(name), jax_towers.build_vision_tower(name)
    assert dataclasses.asdict(full_t.cfg) == dataclasses.asdict(full_j.cfg)
    assert full_t.num_patches == full_j.num_patches
    if "Audio" in name:
        assert full_t.cfg.grid == (9, 74) and full_t.cfg.num_positions == 667
    kw = NAMES[name]
    tower_t = torch_towers.build_vision_tower(name, base_cfg=TorchVisionConfig(**TINY), **kw)
    tower_j = jax_towers.build_vision_tower(name, base_cfg=VisionConfig(**TINY), **kw)
    assert dataclasses.asdict(tower_t.cfg) == dataclasses.asdict(tower_j.cfg)
    tower_j.load_model(rng=jax.random.PRNGKey(4))
    tree = _np(tower_j.params)
    params = to_torch(tree, "cpu")
    back = to_numpy(params)
    for (path, g), w in zip(tree_leaves_with_path(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(g, w, err_msg=path)
    tower_t.load_model(params)
    h, w = tower_t.cfg.grid
    x = np.random.RandomState(5).randn(2, 4, 3, h * 14, w * 14).astype(np.float32)
    want = np.asarray(jax.jit(tower_j.encode_videos)(jnp.asarray(x)))
    with torch.no_grad():
        got = tower_t.encode_videos(torch.from_numpy(x)).numpy()
        one = tower_t(torch.from_numpy(x[0])).numpy()
    assert got.shape == want.shape == (2, 4, h * w, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_RTOL * np.abs(want).max())
    if "Video" in name:  # the frames attend each other: not the frames alone
        assert np.abs(one - got[0]).max() > 1e-3
    else:
        np.testing.assert_allclose(one, got[0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", list(NAMES) + [None, "some/other_tower"])
def test_load_config_takes_the_tower_geometry_from_its_name(tmp_path, name):
    """The builder reads a checkpoint's `mm_image_tower` through
    `tower_config`: each name gives the geometry JAX's `build_vision_tower`
    gives it (none: the image tower), an unknown name raises."""
    import json

    from teochat_torch import builder as torch_builder

    hf = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=4)
    if name is not None:
        hf["mm_image_tower"] = name
    (tmp_path / "config.json").write_text(json.dumps(hf))
    if name == "some/other_tower":
        with pytest.raises(ValueError, match="Unknown vision tower"):
            torch_builder.load_config(str(tmp_path))
        return
    want = jax_towers.build_vision_tower(name or "LanguageBind_Image").cfg
    got = torch_builder.load_config(str(tmp_path)).vision
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("name", ["LanguageBind_Video_merge", "LanguageBind_Audio"])
def test_random_init_builds_the_jax_tree(name):
    kw = NAMES["LanguageBind/" + name]
    tower = torch_towers.build_vision_tower(name, base_cfg=TorchVisionConfig(**TINY), **kw)
    tower.load_model(device="cpu")
    jcfg = jax_towers.build_vision_tower(name, base_cfg=VisionConfig(**TINY), **kw).cfg
    want = jax.eval_shape(lambda: jax_vit.init_vit(jax.random.PRNGKey(0), jcfg))
    assert {p: tuple(x.shape) for p, x in tree_leaves_with_path(tower.params)} == \
        {p: tuple(x.shape) for p, x in tree_leaves_with_path(want)}


@pytest.mark.parametrize("old,new", [(2, 4), (4, 2), (16, 24), (5, 7), (3, 3)])
def test_resize_position_embedding_matches_jax(old, new):
    pos = np.random.RandomState(old * new).randn(1 + old * old, 8).astype(np.float32)
    want = np.asarray(jax_vit.resize_position_embedding(jnp.asarray(pos), old, new))
    got = torch_vit.resize_position_embedding(torch.from_numpy(pos), old, new)
    assert got.shape == want.shape == (1 + new * new, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[0].numpy(), pos[0])  # the CLS row is kept
