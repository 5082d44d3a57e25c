"""The port's chat server, Chat and demo (teochat_torch/serve) on the CPU.

`build_request` gives the JAX package's ids byte for byte; the port's Chat
(incremental sessions) answers as the JAX Chat without sessions (a full
re-prefill each turn) on the same fp32 weights over three turns with
frames and timestamps, the third adding a frame that sorts before the
others; history, the bbox suffix, reset, and a failed turn that commits
nothing; the JAX tests/test_server.py cases against the port's ChatServer
on an ephemeral port; the demo against a stub gradio as tests/test_demo.py
drives it; a turn with `speculative_k` is answered (over HTTP too, its
counters in /stats); `mm_use_im_start_end`'s wrap and `--quantize_vision`
reach the prompt and the loader.
"""

import base64
import dataclasses
import io
import json
import sys
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from teochat_tpu.config import tiny_test_config
from teochat_tpu.data.processing import ImageProcessor as JaxImageProcessor
from teochat_tpu.models import teochat as jax_teochat
from teochat_tpu.serve import chat as jax_chat
from teochat_torch.checkpoint.bridge import to_torch
from teochat_torch.data.processing import ImageProcessor
from teochat_torch.models import teochat as torch_teochat
from teochat_torch.serve import chat as chat_mod
from teochat_torch.serve import demo as demo_mod
from teochat_torch.serve import server as server_mod
from teochat_torch.serve.chat import SYSTEM_PREFIX, Chat, build_request
from teochat_torch.serve.server import ChatServer
from tests.test_demo import FakeChat, _find, _make_stub
from tests.test_eval_e2e import MockTokenizer


@pytest.fixture(scope="module")
def params():
    """The tiny fp32 TEOChat's config and weights (lm_head x40: well-separated argmax)."""
    cfg = dataclasses.replace(tiny_test_config(vocab_size=128), dtype="float32")
    p = jax_teochat.init_teochat(jax.random.PRNGKey(7), cfg)
    llm = dict(p["llm"])
    llm["lm_head"] = {"kernel": llm["lm_head"]["kernel"] * 40.0}
    return cfg, jax.tree.map(np.asarray, {**p, "llm": llm})


def _torch_chat(params, **kw):
    cfg, p = params
    tok = MockTokenizer()
    model = torch_teochat.TEOChat(cfg, to_torch(p, "cpu"), tokenizer=tok)
    return Chat(model_bundle=(tok, model, ImageProcessor(size=28)), **kw)


def _imgs(n=2, seed=0, shape=(40, 40, 3)):
    return [np.random.RandomState(seed + i).randint(0, 255, shape, np.uint8) for i in range(n)]


# ----------------------------------------------------------- build_request


@pytest.mark.parametrize("case", ["first turn with frames", "history and bbox", "text only",
                                  "im_start_end"])
def test_build_request_gives_the_jax_ids(case):
    history = [(SYSTEM_PREFIX + "<video>\nWhat is here?", "a field"), ("And now?", "a road")]
    kwargs = {
        "first turn with frames": dict(text="Describe the change.", image_paths=["b", "a", "c"],
                                       timestamps=["2020-03-01", "2019-01-01", "2020-02-01"]),
        "history and bbox": dict(text="Is it damaged?", image_paths=["b", "a"],
                                 timestamps=["2020-03-01", "2019-01-01"], bbox=[10, 20, 30.7, 40],
                                 history=history, first_turn=False),
        "text only": dict(text="Hello there", image_paths=[]),
        "im_start_end": dict(text="Describe the change.", image_paths=["b", "a"],
                             timestamps=["2020-03-01", "2019-01-01"], mm_use_im_start_end=True),
    }[case]
    proc = types.SimpleNamespace(
        preprocess=lambda paths: {"pixel_values": np.arange(len(paths), dtype=np.float32)})
    want = jax_chat.build_request(tokenizer=MockTokenizer(), processor=proc, **kwargs)
    got = build_request(tokenizer=MockTokenizer(), processor=proc, **kwargs)
    assert np.asarray(got[0], np.int64).tobytes() == np.asarray(want[0], np.int64).tobytes()
    assert got[2:] == want[2:]
    if want[1] is None:
        assert got[1] is None
    else:
        np.testing.assert_array_equal(got[1], want[1])  # frames in chronological order


# ------------------------------------------------------------------- Chat


def test_chat_sessions_answer_as_the_jax_chat_re_prefilling(params):
    """Three turns with timestamps: two frames, text only, then a frame whose
    timestamp sorts before both. The port's incremental Chat (sessions) and
    its re-prefilling Chat give the responses of the JAX Chat without
    sessions; the third turn re-encodes from the first frame."""
    cfg, p = params
    jax_model = jax_teochat.TEOChat(cfg, p, tokenizer=MockTokenizer())
    want_chat = jax_chat.Chat(model_bundle=(jax_model.tokenizer, jax_model,
                                            JaxImageProcessor(size=28)), incremental=False)
    chats = [_torch_chat(params), _torch_chat(params, incremental=False)]
    turns = [("What changed?", _imgs(2, 0, (40, 56, 3)), ["2020-01-05", "2020-06-05"]),
             ("Where exactly?", [], []),
             ("And before that?", _imgs(1, 5, (48, 40, 3)), ["2019-03-05"])]
    for text, imgs, stamps in turns:
        kw = dict(timestamps=stamps, temperature=0.0, max_new_tokens=5)
        want = want_chat.generate(text, imgs, **kw)
        for chat in chats:
            assert chat.generate(text, imgs, **kw) == want
    session = chats[0]._session
    assert session.stats["turns"] == 3
    assert session.frames.shape[0] == 3 and len(chats[0].images) == 3
    assert [h[0] for h in chats[0].history] == [h[0] for h in want_chat.history]


def test_first_turn_prefix_history_bbox_and_reset(params):
    chat = _torch_chat(params)
    r1 = chat.generate("What is here?", _imgs(), temperature=0.0, max_new_tokens=3)
    assert chat.history[0][0].startswith(SYSTEM_PREFIX) and isinstance(r1["response"], str)
    chat.generate("Classify this region", [], bbox=[10, 20, 30, 40], temperature=0.0,
                  max_new_tokens=2)
    assert len(chat.history) == 2 and not chat.history[1][0].startswith(SYSTEM_PREFIX)
    assert chat.history[1][0].endswith("[10, 20, 30, 40]")
    assert chat._session.stats["reused_tokens"] > 0
    chat.reset()
    assert chat.history == [] and chat._first_turn and chat.images == []
    assert chat._session.cache is None and chat._session.tokens == []


def test_a_failed_turn_commits_nothing(params):
    chat = _torch_chat(params)
    chat.generate("First.", _imgs(2), timestamps=["2020-01-01", "2020-02-01"], temperature=0.0,
                  max_new_tokens=3)
    state = (list(chat.history), list(chat.images), list(chat.timestamps), chat._frames.copy(),
             list(chat._session.tokens), chat._session.kv_len, dict(chat._session.stats))
    with pytest.raises(ValueError, match="timestamps must cover"):
        chat.generate("Second.", _imgs(1), temperature=0.0, max_new_tokens=3)
    with pytest.raises(ValueError, match="session cache full"):
        chat.generate("Second.", [], temperature=0.0, max_new_tokens=5000)
    after = (chat.history, chat.images, chat.timestamps, chat._frames, chat._session.tokens,
             chat._session.kv_len, chat._session.stats)
    assert after[:3] == state[:3] and after[4:] == state[4:]
    np.testing.assert_array_equal(after[3], state[3])
    assert not chat._first_turn


def test_unported_options_raise(params):
    """The options this module once refused are ported: `quantize_vision`
    (which, as in the JAX Chat, acts on a load and not on a model bundle)
    and `mm_use_im_start_end`'s wrap around each frame's <image>."""
    assert _torch_chat(params, quantize_vision=True).generate(
        "q", [], temperature=0.0, max_new_tokens=2) == _torch_chat(params).generate(
        "q", [], temperature=0.0, max_new_tokens=2)
    proc = types.SimpleNamespace(
        preprocess=lambda p: {"pixel_values": np.zeros((len(p), 3, 2, 2), np.float32)})
    wrapped, plain = (build_request("q", ["a"], MockTokenizer(), proc, mm_use_im_start_end=w)[0]
                      for w in (True, False))
    want = jax_chat.build_request("q", ["a"], MockTokenizer(), proc, mm_use_im_start_end=True)[0]
    assert list(wrapped) == list(want) and len(wrapped) > len(plain)
    # speculative decoding is ported: a turn with speculative_k is answered,
    # with the tokens of a turn without it
    chat = _torch_chat(params)
    out = chat.generate("q", [], temperature=0.0, max_new_tokens=2, speculative_k=2)
    assert out == _torch_chat(params).generate("q", [], temperature=0.0, max_new_tokens=2)
    assert len(chat.history) == 1 and chat._session.stats["spec_steps"] >= 1


def test_server_main_passes_quantize_vision(monkeypatch):
    """`--quantize_vision` reaches the loader through Chat (the w8a8 tower)."""
    seen = {}

    class Stop(Exception):
        pass

    def fake_chat(*args, **kwargs):
        seen.update(kwargs)
        raise Stop

    monkeypatch.setattr(chat_mod, "Chat", fake_chat)
    monkeypatch.setattr("teochat_torch.utils.resolve_device", lambda device: "cpu")
    with pytest.raises(Stop):
        server_mod.main(["--model_path", "unused", "--quantize_vision"])
    assert seen["quantize_vision"] is True


def test_server_main_needs_a_card(monkeypatch):
    """Without a card the entry point raises before it reads the checkpoint:
    it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(chat_mod, "Chat", lambda *a, **k: pytest.fail("Chat was built"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server_mod.main(["--model_path", "unused"])


# ----------------------------------------------------------------- server


def _b64_image(seed, shape=(40, 40, 3)):
    from PIL import Image

    arr = np.random.RandomState(seed).randint(0, 255, shape, np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


@pytest.fixture(scope="module")
def server(params):
    srv = ChatServer(_torch_chat(params), host="127.0.0.1", port=0)  # port 0: ephemeral
    srv.start_background()
    yield srv
    srv.shutdown()
    assert not srv._worker_thread.is_alive() and not srv._serve_thread.is_alive()


def _url(srv, path):
    return f"http://127.0.0.1:{srv._httpd.server_address[1]}{path}"


def _post(srv, path, payload):
    req = urllib.request.Request(_url(srv, path), data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(srv, path):
    with urllib.request.urlopen(_url(srv, path), timeout=30) as r:
        return r.status, json.loads(r.read())


def test_health(server):
    assert _get(server, "/health") == (200, {"status": "ok"})


def test_generate_round_trip(server):
    code, out = _post(server, "/generate", {
        "prompt": "What changed between these images?",
        "images": [_b64_image(0), _b64_image(1, (30, 50, 3))],
        "timestamps": ["2020-01-01", "2020-02-01"], "temperature": 0.0, "max_new_tokens": 4,
    })
    assert code == 200 and isinstance(out["response"], str) and isinstance(out["bboxes"], list)


def test_generate_missing_prompt_and_bad_requests(server):
    code, out = _post(server, "/generate", {"images": []})
    assert code == 400 and "prompt" in out["error"]
    code, out = _post(server, "/generate", ["not", "an", "object"])
    assert code == 400 and "JSON object" in out["error"]
    code, out = _post(server, "/generate", {"prompt": "q", "stream": True})
    assert code == 400 and "--continuous_batching" in out["error"]  # a stream needs the engine
    code, out = _post(server, "/generate", {"prompt": "q", "session_id": "x",
                                            "speculative_k": 2, "max_new_tokens": 2,
                                            "temperature": 0.0})
    assert code == 200 and isinstance(out["response"], str)  # speculation is ported
    stats = _get(server, "/stats")[1]["sessions"]["x"]
    assert stats["turns"] == 1 and stats["spec_steps"] >= 1 and stats["spec_accepted"] >= 0


def test_unknown_route(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(_url(server, "/nope"), timeout=10)
    assert e.value.code == 404


def test_stats_endpoint(server):
    code, stats = _get(server, "/stats")
    assert code == 200 and stats["mode"] == "session"
    assert set(stats["sessions"]) == set(server._sessions)
    assert all(set(s) >= {"turns", "reused_tokens", "prefilled_tokens"}
               for s in stats["sessions"].values())


def test_multi_session_routing(server):
    """Distinct session_ids keep their own state; /reset clears one, and
    resetting an unknown session makes none."""
    s, r = _post(server, "/generate", {"prompt": "First question .", "images": [],
                                       "temperature": 0.0, "max_new_tokens": 3,
                                       "session_id": "alice"})
    assert s == 200 and isinstance(r["response"], str)
    s, _ = _post(server, "/generate", {"prompt": "Other conversation .", "images": [],
                                       "temperature": 0.0, "max_new_tokens": 3,
                                       "session_id": "bob"})
    assert s == 200
    alice, bob = server._sessions["alice"], server._sessions["bob"]
    assert alice is not bob and alice._session is not bob._session
    assert len(alice.history) == 1 and len(bob.history) == 1
    assert alice.history[0][0] != bob.history[0][0]
    s, r = _post(server, "/reset", {"session_id": "alice"})
    assert s == 200 and r["status"] == "reset"
    assert server._sessions["alice"].history == [] and server._sessions["alice"]._session.cache \
        is None
    assert len(server._sessions["bob"].history) == 1
    before = list(server._sessions)
    assert _post(server, "/reset", {"session_id": "nobody"}) == (200, {"status": "reset"})
    assert list(server._sessions) == before


def test_session_lru_eviction(server):
    server.max_sessions = 3  # the default "" and 2 conversations
    for name in ("c1", "c2", "c3"):
        s, _ = _post(server, "/generate", {"prompt": f"Hello {name} .", "images": [],
                                           "temperature": 0.0, "max_new_tokens": 2,
                                           "session_id": name})
        assert s == 200
    assert "" in server._sessions and len(server._sessions) <= 3
    assert "c3" in server._sessions and "c1" not in server._sessions


# ------------------------------------------------------------------- demo


@pytest.fixture
def stub_gradio(monkeypatch):
    gr = _make_stub()
    monkeypatch.setitem(sys.modules, "gradio", gr)
    return gr


def test_demo_import_error_without_gradio(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(ImportError, match="gradio"):
        demo_mod.build_demo(chat=FakeChat())
    assert len(demo_mod.TEMPORAL_EXAMPLES) == 5 and demo_mod.SINGLE_IMAGE_EXAMPLES


def test_demo_respond_and_reset_wire_to_chat(stub_gradio):
    chat = FakeChat()
    chat_mod.build_demo(chat=chat)
    buttons = _find(stub_gradio, "Button")
    send = next(b for b in buttons if b.args and b.args[0] == "Send")
    clear = next(b for b in buttons if b.args and b.args[0] == "New session")
    respond, inputs, outputs = send.clicks[0]
    assert len(inputs) == 7 and len(outputs) == 2
    img = np.zeros((32, 32, 3), np.uint8)
    mask = np.zeros((32, 32), np.uint8)
    mask[4:12, 8:20] = 255
    history, overlays = respond([img, img], mask, "2023-01-01, 2023-06-01", "what changed?",
                                0.0, 64, [])
    assert chat.calls[0]["n_images"] == 2 and chat.calls[0]["bbox"] is not None
    assert chat.calls[0]["timestamps"] == ["2023-01-01", "2023-06-01"]
    assert history[-1][1].startswith("two buildings changed") and len(overlays) == 2
    respond([img, img], None, "2023-01-01", "q", 0.2, 32, None)
    assert chat.calls[1]["timestamps"] == []  # one timestamp for two frames: dropped
    assert clear.clicks[0][0]() == ([], []) and chat.reset_calls == 1


def test_demo_gallery_and_map_panel(stub_gradio):
    fetched = []

    def fetcher(url):
        fetched.append(url)
        return np.full((256, 256, 3), 9, np.uint8)

    demo_mod.build_demo(chat=FakeChat(), example_dir="/data/examples", tile_fetcher=fetcher,
                        planet_api_key="K")
    labels = [e.get("label") for e in stub_gradio._created["examples"]]
    assert "Single Image Examples" in labels and "Temporal Image Examples" in labels
    buttons = _find(stub_gradio, "Button")
    single = next(b for b in buttons if b.args and b.args[0] == "Use map image")
    temporal = next(b for b in buttons if b.args and b.args[0] == "Use temporal map sequence")
    view, gallery = single.clicks[0][0](37.77, -122.42, 15, "Google Maps")
    assert view.shape == (512, 512, 3) and (view == 9).all() and len(gallery) == 1
    fetched.clear()
    view, gallery = temporal.clicks[0][0](37.77, -122.42, 15)
    assert len(gallery) == 4 and all("planet.com" in u and "api_key=K" in u for u in fetched)
