"""checkpoint/weights.py on the port's checkpoints against the JAX package's
functions on the same trees (tests/test_weights_utils.py's cases), on the CPU.

The same weights on both sides (JAX's init, carried over by the bridge),
each side's checkpoints written by its own orbax_io. The merge is held to
JAX's merged kernels to 1e-6 (one fp32 product a kernel, summed in another
order); deltas, consolidation and the file maps exactly. The upload's
transport is injected: nothing is ever sent.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from teochat_tpu.checkpoint import orbax_io as jax_io
from teochat_tpu.checkpoint import weights as jax_weights
from teochat_tpu.config import tiny_test_config
from teochat_tpu.models.teochat import init_teochat
from teochat_tpu.train.lora import add_lora_params
from teochat_torch.checkpoint import orbax_io, weights
from teochat_torch.checkpoint.bridge import to_numpy, to_torch
from teochat_torch.config import TEOChatConfig
from teochat_torch.utils import tree_leaves_with_path
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_test_config()
    return jcfg, TEOChatConfig.from_json(jcfg.to_json()), _np(
        init_teochat(jax.random.PRNGKey(0), jcfg))


def _flat(tree):
    return {p: np.asarray(x) for p, x in tree_leaves_with_path(to_numpy(tree))}


def test_merge_lora_weights_matches_jax(tiny, tmp_path):
    jcfg, cfg, params = tiny
    lora = _np(add_lora_params(jax.random.PRNGKey(1), params["llm"], rank=4))
    lora["layers"]["attn"]["q"]["lora_b"] = np.full_like(lora["layers"]["attn"]["q"]["lora_b"], 0.01)
    tree = {**params, "llm": lora}
    jsrc = jax_io.save_checkpoint(str(tmp_path / "jax_lora"), jax.tree.map(jnp.asarray, tree), jcfg)
    want, _, _ = jax_io.load_checkpoint(jax_weights.merge_lora_weights(jsrc, str(tmp_path / "jm")))
    src = orbax_io.save_checkpoint(str(tmp_path / "lora"), to_torch(tree, "cpu"), cfg)
    got, got_cfg, _ = orbax_io.load_checkpoint(weights.merge_lora_weights(src, str(tmp_path / "m")))
    assert got_cfg == cfg
    assert "lora_a" not in got["llm"]["layers"]["attn"]["q"]
    got, want = _flat(got), {p: np.asarray(x) for p, x in tree_leaves_with_path(_np(want))}
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=1e-6, atol=1e-6, err_msg=path)
    q = got["llm/layers/attn/q/kernel"] - params["llm"]["layers"]["attn"]["q"]["kernel"]
    assert np.abs(q).max() > 1e-5


def test_make_and_apply_delta_match_jax(tiny):
    jcfg, _, base = tiny
    target = _np(init_teochat(jax.random.PRNGKey(1), jcfg))
    want = _np(jax_weights.make_delta(base, target))
    delta = weights.make_delta(to_torch(base, "cpu"), to_torch(target, "cpu"))
    got, want = _flat(delta), {p: np.asarray(x) for p, x in tree_leaves_with_path(want)}
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg=path)
    recon = _flat(weights.apply_delta(to_torch(base, "cpu"), delta))
    jrecon = _np(jax_weights.apply_delta(base, jax_weights.make_delta(base, target)))
    for path, w in tree_leaves_with_path(jrecon):
        np.testing.assert_array_equal(recon[path], np.asarray(w), err_msg=path)
    with pytest.raises(ValueError, match="differ"):
        weights.make_delta(to_torch(base, "cpu"), to_torch({"llm": target["llm"]}, "cpu"))


def test_consolidate_matches_jax(tiny, tmp_path):
    """Re-saved whole with its config; a checkpoint without one gets the
    default config, as JAX's auto-upgrade gives."""
    jcfg, cfg, params = tiny
    src = orbax_io.save_checkpoint(str(tmp_path / "src"), to_torch(params, "cpu"), cfg)
    got, got_cfg, _ = orbax_io.load_checkpoint(weights.consolidate_ckpt(src, str(tmp_path / "dst")))
    assert got_cfg == cfg
    for path, w in tree_leaves_with_path(params):
        np.testing.assert_array_equal(_flat(got)[path], w, err_msg=path)
    bare = orbax_io.save_checkpoint(str(tmp_path / "bare"), to_torch(params, "cpu"))
    _, upgraded, _ = orbax_io.load_checkpoint(weights.consolidate_ckpt(bare, str(tmp_path / "up")))
    jbare = jax_io.save_checkpoint(str(tmp_path / "jbare"), jax.tree.map(jnp.asarray, params))
    _, jupgraded, _ = jax_io.load_checkpoint(jax_weights.consolidate_ckpt(jbare, str(tmp_path / "ju")))
    assert upgraded.to_json() == TEOChatConfig.from_json(jupgraded.to_json()).to_json()


def test_upload_collects_what_jax_collects_through_the_injected_transport(tiny, tmp_path):
    """The file map is every file of the checkpoint by repo-relative name
    plus the tokenizer files that exist, as JAX's collects from the same
    directories; the transport receives it, and nothing else is called."""
    _, cfg, params = tiny
    ckpt = orbax_io.save_checkpoint(str(tmp_path / "ckpt"), to_torch(params, "cpu"), cfg)
    tok = tmp_path / "tok"
    tok.mkdir()
    (tok / "tokenizer_config.json").write_text("{}")
    (tok / "special_tokens_map.json").write_text("{}")
    calls = []
    files = weights.upload_weights(ckpt, "someone/teochat", tokenizer_path=str(tok), private=True,
                                   transport=lambda *a: calls.append(a))
    assert files == jax_weights.collect_upload_files(ckpt, str(tok))
    assert calls == [("someone/teochat", files, True)]
    assert "tokenizer_config.json" in files and "tokenizer.model" not in files
    assert "params/tree.safetensors" in files and "config.json" in files
    with pytest.raises(FileNotFoundError):
        weights.upload_weights(str(tmp_path / "nope"), "r/r", transport=lambda *a: None)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="empty"):
        weights.collect_upload_files(str(empty))


def test_default_transport_names_huggingface_hub(monkeypatch, tmp_path):
    """Without an injected transport the upload goes through huggingface_hub;
    here its client is replaced, so nothing leaves the machine."""
    import sys
    import types

    seen = []

    class Api:
        def create_repo(self, repo_id, private, exist_ok):
            seen.append(("repo", repo_id, private))

        def upload_file(self, path_or_fileobj, path_in_repo, repo_id):
            seen.append(("file", path_in_repo))

    monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(HfApi=Api))
    d = tmp_path / "c"
    d.mkdir()
    (d / "config.json").write_text("{}")
    weights.upload_weights(str(d), "r/r")
    assert seen == [("repo", "r/r", False), ("file", "config.json")]
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="huggingface_hub"):
        weights.upload_weights(str(d), "r/r")
