"""The port's own copies of the JAX package's host modules (config,
constants, conversation, mm_utils, utils, data.sampler, data.processing,
data.processing_extra, eval.inference, eval.classification, eval.detection,
eval.geometry, serve.maptiles, and serve.chat's host helpers) behave as
their originals (the extra processors' pixels equal, exactly),
the port imports nothing of JAX or of the JAX package, and its entry points
default to the card."""

import dataclasses
import pathlib
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from teochat_tpu import config as jax_config
from teochat_tpu import constants as jax_constants
from teochat_tpu import conversation as jax_conv
from teochat_tpu import mm_utils as jax_mm
from teochat_tpu import utils as jax_utils
from teochat_tpu.data import sampler as jax_sampler
from teochat_tpu.eval import classification as jax_classification
from teochat_tpu.eval import detection as jax_detection
from teochat_tpu.eval import geometry as jax_geometry
from teochat_tpu.eval import inference as jax_inference
from teochat_tpu.serve import chat as jax_chat
from teochat_tpu.serve import maptiles as jax_maptiles
from teochat_torch import config as torch_config
from teochat_torch import constants as torch_constants
from teochat_torch import conversation as torch_conv
from teochat_torch import mm_utils as torch_mm
from teochat_torch import utils as torch_utils
from teochat_torch.checkpoint import bridge
from teochat_torch.data import processing as torch_processing
from teochat_torch.data import sampler as torch_sampler
from teochat_torch.eval import classification as torch_classification
from teochat_torch.eval import detection as torch_detection
from teochat_torch.eval import geometry as torch_geometry
from teochat_torch.eval import inference as torch_inference
from teochat_torch.models import llama as torch_llama
from teochat_torch.serve import chat as torch_chat
from teochat_torch.serve import maptiles as torch_maptiles
from tests._torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIG_CLASSES = ["VisionConfig", "ProjectorConfig", "LlamaConfig", "MptConfig",
                  "GenerationConfig", "MeshConfig", "TEOChatConfig"]


def _fields(cls):
    out = {}
    for f in dataclasses.fields(cls):
        default = f.default if f.default is not dataclasses.MISSING else (
            f.default_factory() if f.default_factory is not dataclasses.MISSING else "<required>")
        # nested configs compare by their own fields
        out[f.name] = dataclasses.asdict(default) if dataclasses.is_dataclass(default) else default
    return out


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_dataclass_fields_and_defaults(name):
    assert _fields(getattr(torch_config, name)) == _fields(getattr(jax_config, name))


def test_tiny_test_config_and_json_round_trip():
    want, got = jax_config.tiny_test_config(vocab_size=96), torch_config.tiny_test_config(vocab_size=96)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_json() == want.to_json()
    # a config serialized by either package loads in the other
    assert dataclasses.asdict(torch_config.TEOChatConfig.from_json(want.to_json())) == \
        dataclasses.asdict(want)
    assert got.llm.head_dim == want.llm.head_dim and got.vision.num_patches == want.vision.num_patches
    hf = {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
          "num_attention_heads": 4, "vocab_size": 100}
    assert dataclasses.asdict(torch_config.llama_config_from_hf(hf)) == \
        dataclasses.asdict(jax_config.llama_config_from_hf(hf))


def test_constants_equal():
    names = [n for n in dir(jax_constants) if n.isupper()]
    assert len(names) >= 20 and names == [n for n in dir(torch_constants) if n.isupper()]
    for n in names:
        assert getattr(torch_constants, n) == getattr(jax_constants, n), n


def _render(mod, name, turns):
    conv = mod.conv_templates[name].copy()
    for i, text in enumerate(turns):
        conv.append_message(conv.roles[i % 2], text)
    try:
        return conv.get_prompt(), conv.sep, conv.sep2, conv.sep_style.name
    except (TypeError, AssertionError) as e:  # a template that cannot render these turns
        return type(e).__name__


@pytest.mark.parametrize("name", sorted(jax_conv.conv_templates))
def test_conversation_templates_render_the_same_prompt(name):
    assert sorted(torch_conv.conv_templates) == sorted(jax_conv.conv_templates)
    one_turn = ["<image>\nWhat changed between the images?", None]
    two_turns = [one_turn[0], "A building was demolished.", "Where?", None]
    single = _render(torch_conv, name, one_turn)
    assert isinstance(single, tuple) and single == _render(jax_conv, name, one_turn)
    assert _render(torch_conv, name, two_turns) == _render(jax_conv, name, two_turns)
    assert torch_conv.default_conversation.get_prompt() == jax_conv.default_conversation.get_prompt()


class WordTokenizer:
    bos_token_id = 1

    def __init__(self):
        self.vocab = {}

    def __call__(self, text):
        ids = [1] + [self.vocab.setdefault(w, len(self.vocab) + 10) for w in text.split()]
        return types.SimpleNamespace(input_ids=ids)

    def decode(self, ids):
        return " ".join(f"<{int(i)}>" for i in ids)


@pytest.mark.parametrize("prompt", [
    "USER: <image> what is this ASSISTANT:",
    "Image 1: <image> Image 2: <image> compare them",
    "no image here",
    "<image>",
])
def test_tokenizer_image_token_same_ids(prompt):
    want = jax_mm.tokenizer_image_token(prompt, WordTokenizer())
    assert torch_mm.tokenizer_image_token(prompt, WordTokenizer()) == want
    np.testing.assert_array_equal(
        torch_mm.tokenizer_image_token(prompt, WordTokenizer(), return_tensors="np"),
        jax_mm.tokenizer_image_token(prompt, WordTokenizer(), return_tensors="np"))
    pt = torch_mm.tokenizer_image_token(prompt, WordTokenizer(), return_tensors="pt")
    assert pt.dtype == torch.long and pt.tolist() == want
    assert torch_mm.get_model_name_from_path("a/b/checkpoint-7/") == \
        jax_mm.get_model_name_from_path("a/b/checkpoint-7/")


def test_order_pick_k_same_pick():
    items = list("abcdefghijklmnop")
    for k in (3, 16, 40):
        np.random.seed(5)
        want = jax_utils.order_pick_k(items, k)
        np.random.seed(5)
        assert torch_utils.order_pick_k(items, k) == want


@pytest.mark.parametrize("group_by_modality", [False, True])
def test_length_grouped_sampler_same_indices(group_by_modality):
    rs = np.random.RandomState(6)
    lengths = (rs.randint(5, 400, 97) * rs.choice([1, -1], 97)).tolist()
    kwargs = dict(batch_size=4, world_size=2, lengths=lengths, group_by_modality=group_by_modality)
    want = jax_sampler.LengthGroupedSampler(generator=np.random.RandomState(3), **kwargs)
    got = torch_sampler.LengthGroupedSampler(generator=np.random.RandomState(3), **kwargs)
    assert len(got) == len(want) and list(got) == list(want)
    assert sorted(got) == list(range(97))


def test_to_pil_accepts_arrays_and_images():
    pytest.importorskip("PIL")
    from teochat_tpu.data.processing import _to_pil as jax_to_pil

    rs = np.random.RandomState(7)
    for arr in (rs.randint(0, 255, (5, 6, 3)).astype(np.uint8), rs.rand(5, 6, 3).astype(np.float32)):
        want, got = jax_to_pil(arr), torch_processing._to_pil(arr)
        assert got.mode == "RGB" and got.size == want.size
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert torch_processing._to_pil(got) is not None
    with pytest.raises(TypeError):
        torch_processing._to_pil(3)


class StubModel:
    """Records what `generate` is given and answers with fixed ids."""

    cfg = types.SimpleNamespace(mm_use_im_start_end=False)
    tokens_per_frame = 4

    def __init__(self):
        self.calls = []

    def generate(self, input_ids, pixel_values, gen, rng=None):
        self.calls.append((input_ids, pixel_values, gen, rng))
        return [[11, 12, 13]]


class StubProcessor:
    def preprocess(self, paths):
        return {"pixel_values": np.full((len(paths), 3, 2, 2), len(paths), np.float32)}


@pytest.mark.parametrize("strategy,prefix", [("interleave", True), (None, False)])
def test_run_inference_single_same_prompt_ids_and_output(strategy, prefix):
    kwargs = dict(
        inp="These are images taken at different times: <video> Were any buildings damaged?",
        image_paths=["b.png", "a.png", "c.png"], timestamps=["2020-03-01", "2020-01-01", "2020-02-01"],
        prompt_strategy=strategy, chronological_prefix=prefix, temperature=0.0, max_new_tokens=5)
    calls = []
    for mod in (jax_inference, torch_inference):
        model = StubModel()
        text = mod.run_inference_single(model, StubProcessor(), WordTokenizer(), **kwargs)
        (ids, pixels, gen, rng), = model.calls
        calls.append((text, ids, pixels.tolist(), dataclasses.asdict(gen), rng))
    assert calls[0] == calls[1]
    assert calls[0][0] == "<11> <12> <13>"
    # the frames are sorted by time before they are named in the prompt
    assert torch_inference._build_prompt(
        kwargs["inp"], kwargs["image_paths"], "v1", kwargs["timestamps"], strategy, prefix,
    ) == jax_inference._build_prompt(
        kwargs["inp"], kwargs["image_paths"], "v1", kwargs["timestamps"], strategy, prefix)


def test_inference_helpers_same_results():
    text = "boxes [1, 2, 3, 4] and [10, 20, 30, 40]"
    assert torch_inference.extract_bboxes(text) == jax_inference.extract_bboxes(text) == \
        [[1, 2, 3, 4], [10, 20, 30, 40]]
    assert torch_inference.replace_video_token("x <video> y", ["a", "b"], "interleave") == \
        jax_inference.replace_video_token("x <video> y", ["a", "b"], "interleave")
    example = {"conversations": [{"value": "find [1, 2, 3, 4]"}, {"value": "at [5, 6, 7, 8]"}],
               "task": "det", "video": ["a.png"], "timestamp": ["2020-01-01"]}
    assert torch_inference._collect_output(example, "r", "fmow") == \
        jax_inference._collect_output(example, "r", "fmow")
    with pytest.raises(ValueError):
        torch_inference._collect_output(example, "r", "xbd_loc")
    # the dataset loop goes one example at a time, through the port's own function
    outs = [mod.run_inference([example], StubModel(), WordTokenizer(), StubProcessor(), "interleave",
                              True, "v1", 0.0, 4, progress=False)
            for mod in (jax_inference, torch_inference)]
    assert outs[0] == outs[1] and outs[1][0]["response"] == "<11> <12> <13>"
    # batch_size > 1 goes through the batched loop, the port's own as JAX's
    outs = [mod.run_inference([example], StubModel(), WordTokenizer(), StubProcessor(),
                              "interleave", True, "v1", 0.0, 4, batch_size=2, progress=False)
            for mod in (jax_inference, torch_inference)]
    assert outs[0] == outs[1] and outs[1][0]["response"] == "<11> <12> <13>"


# the JAX package, the JAX scripts (scripts/*.py) and the JAX bench (bench.py) at the root
IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|teochat_tpu|scripts|bench)\b", re.M)


def test_port_has_no_import_of_jax_or_the_jax_package():
    files = sorted((REPO / "teochat_torch").rglob("*.py")) + [REPO / "chip_smoke.py",
                                                              REPO / "chip_probe.py"]
    assert len(files) > 25
    names = {str(f.relative_to(REPO)) for f in files}
    assert {f"teochat_torch/bench/{m}.py" for m in ("_timing", "int4_kernel", "vit_attention",
                                                     "main")} <= names
    assert {f"teochat_torch/{m}.py" for m in (
        "builder", "checkpoint/convert_hf", "native/__init__", "models/towers", "eval/eval",
        "eval/classification", "eval/detection", "eval/geometry", "data/processing",
        "data/processing_extra", "vision_tokenizer", "ops/quant", "serve/__init__", "serve/session", "serve/chat", "serve/server",
        "serve/demo", "serve/maptiles")} <= names
    bad = [(str(f.relative_to(REPO)), m.group(0).strip())
           for f in files for m in IMPORT_RE.finditer(f.read_text())]
    assert not bad, bad


def test_entry_points_default_to_the_card_and_take_the_cpu_on_request():
    assert torch_utils.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert torch_utils.resolve_device(None).type == "cuda"
        return
    cfg = torch_config.tiny_test_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.to_torch({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.init_teochat(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_llama.init_cache(cfg.llm, 1, 4)
    assert bridge.to_torch({"w": np.zeros(2, np.float32)}, "cpu")["w"].device.type == "cpu"


CLS_OUTPUTS = [
    {"response": "Residential!", "ground_truth": "residential", "task": "cls"},
    {"response": "commercial", "ground_truth": "residential", "task": "cls"},
    {"response": "Yes, it is", "ground_truth": "yes", "task": "qa"},
    {"response": "no", "ground_truth": "no", "task": "qa"},
]


@pytest.mark.parametrize("kwargs", [{}, {"keywords": ["yes", "no"]}, {"ignore_casing": False},
                                    {"ignore_punctuation": False, "keywords": ["residential"]}])
def test_classification_metrics_equal(kwargs):
    want = jax_classification.classification_metrics(CLS_OUTPUTS, **kwargs)
    assert torch_classification.classification_metrics(CLS_OUTPUTS, **kwargs) == want


WKTS = [
    "POLYGON ((1 1, 20 1, 20 15, 1 15, 1 1))",
    "POLYGON ((0 0, 30 0, 30 30, 0 30, 0 0), (5 5, 9 5, 9 9, 5 9, 5 5))",
    "MULTIPOLYGON (((2 2, 6 2, 6 6, 2 2)), ((10 10, 14 10, 14 18, 10 10)))",
    "GEOMETRYCOLLECTION (POLYGON ((3 3, 8 3, 8 8, 3 3)), POINT (1 1))",
    "POLYGON EMPTY",
]


@pytest.mark.parametrize("wkt", WKTS + [WKTS[:2]])
def test_geometry_equal(wkt):
    assert torch_geometry.wkt_exteriors(wkt) == jax_geometry.wkt_exteriors(wkt)
    for size in ((32, 32), (24, 40)):
        np.testing.assert_array_equal(torch_geometry.create_mask(wkt, size),
                                      jax_geometry.create_mask(wkt, size))
    boxes = [[1.5, 2.0, 10.0, 12.25], [0, 0, 3, 4]]
    assert torch_geometry.boxes_to_wkt(boxes) == jax_geometry.boxes_to_wkt(boxes)
    with pytest.raises(ValueError):
        torch_geometry.wkt_exteriors("CIRCLE (1 1)")


def _det_outputs():
    poly = "POLYGON ((10 10, 120 10, 120 100, 10 100, 10 10))"
    return {
        "xbd_loc": [
            {"task": "change_detection_localization", "polygon": [poly],
             "ground_truth": "[4, 4, 47, 39]", "response": "[5, 5, 45, 40], [60, 60, 70, 80]"},
            {"task": "change_detection_localization", "polygon": [poly],
             "ground_truth": "[4, 4, 47, 39]", "response": "no buildings"},
        ],
        "xbd_dmg_cls": [
            {"task": "change_detection_classification", "ground_truth": "major damage",
             "response": "Major damage.", "polygon": [poly]},
            {"task": "change_detection_classification", "ground_truth": "destroyed",
             "response": "minor damage", "polygon": [poly]},
            {"task": "change_detection_classification", "ground_truth": "no damage",
             "response": "no damage", "polygon": [poly]},
        ],
        "qfabric_rqa5_rtqa5": [
            {"task": "region_based_temporal_question_answering", "ground_truth": "prior construction",
             "response": "prior construction", "polygon": [poly]},
            {"task": "region_based_temporal_question_answering", "ground_truth": "construction done",
             "response": "greenland", "polygon": [poly]},
        ],
        "s2_rqa": [
            {"task": "region_based_question_answering", "ground_truth": "Yes", "response": "yes"},
        ],
    }


@pytest.mark.parametrize("dataset", sorted(_det_outputs()))
def test_detection_metrics_equal(dataset):
    outputs = _det_outputs()[dataset]
    want = jax_detection.detection_metrics(outputs, dataset_name=dataset)
    got = torch_detection.detection_metrics(outputs, dataset_name=dataset)
    assert sorted(got) == sorted(want) and got
    np.testing.assert_array_equal([got[k] for k in sorted(got)], [want[k] for k in sorted(want)])
    with pytest.raises(ValueError):
        torch_detection.detection_metrics(outputs, dataset_name="unknown")


def test_eval_modules_import_without_pillow():
    """The eval driver and the classification metrics import where Pillow is
    missing; geometry reaches for it only when it draws."""
    code = (
        "import sys\n"
        "sys.modules['PIL'] = None\n"
        "import teochat_torch.eval.eval, teochat_torch.eval.detection, teochat_torch.builder\n"
        "from teochat_torch.eval import geometry\n"
        "assert geometry.wkt_exteriors('POLYGON ((0 0, 1 0, 1 1, 0 0))')\n"
        "try:\n"
        "    geometry.create_mask('POLYGON ((0 0, 1 0, 1 1, 0 0))', (4, 4))\n"
        "except ImportError:\n"
        "    print('drawing needs PIL')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "drawing needs PIL" in res.stdout


def _module_body(mod):
    """The source after the module docstring."""
    text = pathlib.Path(mod.__file__).read_text()
    return text[text.index('"""', 3) + 3:]


def test_maptiles_is_the_original():
    """serve/maptiles.py is the JAX package's module, its docstring aside,
    and renders the same views from the same canned tiles."""
    assert _module_body(torch_maptiles) == _module_body(jax_maptiles)
    assert torch_maptiles.BASEMAP_SOURCES == jax_maptiles.BASEMAP_SOURCES
    assert torch_maptiles.TEMPORAL_BASEMAPS == jax_maptiles.TEMPORAL_BASEMAPS

    def fetcher(url):
        seed = sum(map(ord, url)) % 2**31
        return np.random.RandomState(seed).randint(0, 255, (256, 256, 3), np.uint8)

    for lat, lon, zoom in ((37.77, -122.42, 15), (-33.9, 151.2, 3), (85.0, 179.9, 2)):
        np.testing.assert_array_equal(
            torch_maptiles.render_map_view(lat, lon, zoom, "Google Maps", fetcher=fetcher),
            jax_maptiles.render_map_view(lat, lon, zoom, "Google Maps", fetcher=fetcher))
        got = torch_maptiles.get_temporal_map_images(lat, lon, zoom, fetcher=fetcher,
                                                     planet_api_key="K")
        want = jax_maptiles.get_temporal_map_images(lat, lon, zoom, fetcher=fetcher,
                                                    planet_api_key="K")
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_chat_host_helpers_equal_the_originals():
    """serve/chat.py's helpers that hold no model call: the system prefix,
    mask2bbox (a brush mask, its RGBA layer, an empty one) and draw_bboxes."""
    assert torch_chat.SYSTEM_PREFIX == jax_chat.SYSTEM_PREFIX
    mask = np.zeros((32, 48), np.uint8)
    mask[4:12, 8:20] = 255
    rgba = np.zeros((32, 48, 4), np.uint8)
    rgba[..., -1] = mask
    for m in (mask, rgba, np.zeros((4, 4)), None):
        assert torch_chat.mask2bbox(m) == jax_chat.mask2bbox(m)
    img = np.random.RandomState(3).randint(0, 255, (40, 56, 3), np.uint8)
    for boxes, thickness in (([[10, 20, 50, 60]], 2), ([[0, 0, 100, 100], [5, 5, 6, 90]], 3)):
        np.testing.assert_array_equal(torch_chat.draw_bboxes(img.copy(), boxes, thickness=thickness),
                                      jax_chat.draw_bboxes(img.copy(), boxes, thickness=thickness))


# ------------------------------------------------- data/processing_extra.py


def _clip(n=9, hw=(30, 40), seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, *hw, 3), np.uint8)


@pytest.mark.parametrize("case", ["frames list", "array", "batch", "file"])
def test_video_processor_equals_the_original(case, tmp_path):
    """Decoded frames as a list, a [T, H, W, 3] array and a batch of clips
    of other lengths, and an mp4 decoded by cv2: the same pixels."""
    from teochat_tpu.data import processing_extra as jax_extra
    from teochat_torch.data import processing_extra as torch_extra

    if case == "frames list":
        videos = [list(_clip())]
    elif case == "array":
        videos = _clip(12)
    elif case == "batch":
        videos = [_clip(5, seed=1), _clip(16, seed=2)]
    else:
        cv2 = pytest.importorskip("cv2")
        videos = str(tmp_path / "clip.mp4")
        out = cv2.VideoWriter(videos, cv2.VideoWriter_fourcc(*"mp4v"), 5, (40, 32))
        if not out.isOpened():
            pytest.skip("this cv2 cannot write mp4")
        for i in range(12):
            out.write(np.full((32, 40, 3), i * 20, np.uint8))
        out.release()
    want = jax_extra.VideoProcessor(num_frames=4, size=28).preprocess(videos)["pixel_values"]
    got = torch_extra.VideoProcessor(num_frames=4, size=28)(videos)["pixel_values"]
    assert got.shape == want.shape and got.shape[1:] == (4, 3, 28, 28)
    np.testing.assert_array_equal(got, want)
    for total, n in ((100, 8), (3, 8), (1, 4)):
        np.testing.assert_array_equal(torch_extra.uniform_frame_indices(total, n),
                                      jax_extra.uniform_frame_indices(total, n))
    with pytest.raises(ValueError, match="empty video"):
        torch_extra.uniform_frame_indices(0, 8)


def test_video_backends_fail_as_the_original(tmp_path):
    """An unknown backend raises NameError at construction; decord and
    pytorchvideo, where they are not installed, raise ImportError naming
    the opencv default when a path is decoded (arrays need neither)."""
    from teochat_torch.data import processing_extra as torch_extra

    with pytest.raises(NameError, match="video_decode_backend"):
        torch_extra.VideoProcessor(video_decode_backend="nvdec")
    for backend in ("decord", "pytorchvideo"):
        vp = torch_extra.VideoProcessor(num_frames=2, size=28, video_decode_backend=backend)
        assert vp(_clip(3))["pixel_values"].shape == (1, 2, 3, 28, 28)
        try:
            vp._decode(str(tmp_path / "missing.mp4"))
        except ImportError as e:
            assert "opencv" in str(e)
        except Exception:  # noqa: BLE001 - the library is installed and the file is missing
            pass


def test_depth_thermal_and_audio_processors_equal_the_originals():
    from teochat_tpu.data import processing_extra as jax_extra
    from teochat_torch.data import processing_extra as torch_extra

    rs = np.random.RandomState(3)
    depth = [rs.rand(50, 60) * 10, rs.rand(40, 40, 1) * 3, np.zeros((30, 30))]
    for cls, kw in (("DepthProcessor", {}), ("DepthProcessor", {"max_depth": 4.0}),
                    ("ThermalProcessor", {})):
        want = getattr(jax_extra, cls)(size=28, **kw).preprocess(depth)["pixel_values"]
        got = getattr(torch_extra, cls)(size=28, **kw)(depth)["pixel_values"]
        assert got.shape == (3, 3, 28, 28)
        np.testing.assert_array_equal(got, want)
    t = np.linspace(0, 1, 8000, dtype=np.float32)
    waves = [np.sin(2 * np.pi * 440 * t), rs.randn(3000).astype(np.float32)]
    kw = dict(sample_rate=8000, num_mels=16, target_length=64, size=28)
    want = jax_extra.AudioProcessor(**kw).preprocess(waves)["pixel_values"]
    got = torch_extra.AudioProcessor(**kw)(waves)["pixel_values"]
    assert got.shape == (2, 3, 28, 28) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
