"""Serving layer: the `Chat` session wrapper and the bbox helpers.

Port of teochat_tpu/serve/chat.py (itself a rebuild of the serving core of
reference videollava/serve/teochat_demo.py): `Chat` (:466-546) with the
temporal system prefix on a first turn (:516-521), `mask2bbox` (brush mask
-> [0, 100] bbox, :102-120) and `draw_bboxes` (the cv2 overlay, :62-101,
303-340; cv2 is imported only when it draws). `build_request` assembles one
turn's prompt from the port's own copies of the conversation templates and
tokenizer helpers. `build_demo` (serve/demo.py) needs gradio.
"""

from __future__ import annotations

from datetime import datetime
from typing import List, Optional, Sequence, Tuple

import numpy as np

from teochat_torch.eval.inference import extract_bboxes

SYSTEM_PREFIX = (
    "This a sequence of satellite images taken of the same location at different "
    "times in chronological order: "
)


def mask2bbox(mask: Optional[np.ndarray]) -> Optional[List[int]]:
    """Brush-layer mask -> [x1, y1, x2, y2] in [0, 100] image-percent coords
    (reference teochat_demo.py:102-120)."""
    if mask is None:
        return None
    mask = np.asarray(mask)
    if mask.ndim == 3:
        mask = mask[..., -1]  # alpha channel of an RGBA brush layer
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return None
    h, w = mask.shape
    x1, x2 = xs.min() / w * 100, xs.max() / w * 100
    y1, y2 = ys.min() / h * 100, ys.max() / h * 100
    return [int(round(x1)), int(round(y1)), int(round(x2)), int(round(y2))]


def draw_bboxes(
    image: np.ndarray,
    bboxes: Sequence[Sequence[float]],
    color: Tuple[int, int, int] = (255, 0, 0),
    thickness: int = 2,
) -> np.ndarray:
    """Draw [0,100]-normalized boxes on an RGB uint8 image (cv2 if present,
    reference teochat_demo.py:303-340)."""
    img = np.ascontiguousarray(np.asarray(image))
    h, w = img.shape[:2]
    try:
        import cv2

        for b in bboxes:
            p1 = (int(b[0] / 100 * w), int(b[1] / 100 * h))
            p2 = (int(b[2] / 100 * w), int(b[3] / 100 * h))
            cv2.rectangle(img, p1, p2, color, thickness)
        return img
    except ImportError:
        for b in bboxes:
            x1, y1 = int(b[0] / 100 * w), int(b[1] / 100 * h)
            x2, y2 = int(b[2] / 100 * w), int(b[3] / 100 * h)
            for t in range(thickness):
                img[max(y1 - t, 0), x1:x2] = color
                img[min(y2 + t, h - 1), x1:x2] = color
                img[y1:y2, max(x1 - t, 0)] = color
                img[y1:y2, min(x2 + t, w - 1)] = color
        return img


def _chronological(timestamps: Sequence[str]) -> List[int]:
    """The indices of `timestamps` (YYYY-MM-DD) in time order, ties kept."""
    return sorted(range(len(timestamps)),
                  key=lambda i: datetime.strptime(timestamps[i], "%Y-%m-%d"))


def build_request(
    text: str,
    image_paths: Sequence,
    tokenizer,
    processor,
    *,
    conv_mode: str = "v1",
    timestamps: Sequence[str] = (),
    bbox: Optional[Sequence[float]] = None,
    history: Sequence[Tuple[str, str]] = (),
    first_turn: bool = True,
    pixel_values=None,
    mm_use_im_start_end: bool = False,
):
    """Build (input_ids, pixel_values, stop_str, rendered_text) for one turn.

    Frames are sorted by their timestamps before they are named in the
    prompt; `pixel_values`, when given, are the frames already preprocessed
    in that order (Chat passes its cached ones)."""
    from teochat_torch.constants import IMAGE_TOKEN_INDEX
    from teochat_torch.conversation import SeparatorStyle, conv_templates
    from teochat_torch.eval.inference import replace_video_token
    from teochat_torch.mm_utils import tokenizer_image_token

    if bbox is not None:
        text = f"{text} [{', '.join(str(int(b)) for b in bbox)}]"
    if first_turn and len(image_paths) > 0 and "<video>" not in text:
        text = SYSTEM_PREFIX + "<video>\n" + text

    conv = conv_templates[conv_mode].copy()
    for user_msg, assistant_msg in history:
        conv.append_message(conv.roles[0], user_msg)
        conv.append_message(conv.roles[1], assistant_msg)
    conv.append_message(conv.roles[0], text)
    conv.append_message(conv.roles[1], None)
    prompt = conv.get_prompt().replace("times:", "times in chronological order:")

    image_paths = list(image_paths)
    if timestamps:
        image_paths = [image_paths[i] for i in _chronological(timestamps)]
    prompt = replace_video_token(prompt, image_paths, "interleave")
    if mm_use_im_start_end:
        from teochat_torch.vision_tokenizer import wrap_image_tokens

        prompt = wrap_image_tokens(prompt)

    input_ids = tokenizer_image_token(prompt, tokenizer, IMAGE_TOKEN_INDEX)
    if image_paths and prompt.count("<image>"):
        if pixel_values is None:
            pixel_values = processor.preprocess(image_paths)["pixel_values"]
    else:
        pixel_values = None
    stop_str = conv.sep if conv.sep_style != SeparatorStyle.TWO else conv.sep2
    return input_ids, pixel_values, stop_str, text


class Chat:
    """Stateful chat over a TEOChat model (reference :466-546).

    `incremental` keeps one KV cache across turns and prefills only each
    turn's suffix (serve/session.py); otherwise every turn re-prefills the
    whole conversation, as the reference demo does."""

    def __init__(
        self,
        model_path: Optional[str] = None,
        conv_mode: str = "v1",
        load_8bit: bool = True,
        quantize_vision: bool = False,
        model_bundle=None,
        vision_path: Optional[str] = None,
        incremental: bool = True,
        session_max_len: int = 4096,
        device=None,
    ):
        if model_bundle is not None:
            self.tokenizer, self.model, self.processor = model_bundle
        else:
            from teochat_torch.eval.eval import load_model

            self.tokenizer, self.model, self.processor = load_model(
                model_path, load_8bit=load_8bit, vision_path=vision_path,
                quantize_vision=quantize_vision, device=device)
        self.conv_mode = conv_mode
        self._session = None
        if incremental:
            from teochat_torch.serve.session import ChatSession

            self._session = ChatSession(self.model, max_len=session_max_len)
        self.reset()

    def reset(self) -> None:
        self.history: List[Tuple[str, str]] = []
        # the frames of the conversation so far, as given, with their
        # timestamps: history turns keep their <image> tokens, which expand
        # against every frame seen (the reference demo accumulates its
        # img_list the same way, teochat_demo.py:379-463). _frames holds each
        # one preprocessed (aligned with self.images), so a frame is decoded
        # and resized on the host once a conversation.
        self.images: List = []
        self.timestamps: List[str] = []
        self._frames = None  # np [len(images), 3, H, W]
        self._first_turn = True
        if self._session is not None:
            self._session.reset()

    def generate(
        self,
        text: str,
        image_paths: Sequence,
        timestamps: Sequence[str] = (),
        bbox: Optional[Sequence[float]] = None,
        temperature: float = 0.2,
        max_new_tokens: int = 256,
        speculative_k: int = 0,
    ) -> dict:
        """One chat turn. Returns {'response', 'bboxes'}. A first turn with
        frames gets the temporal system prefix and <video> (reference
        :516-521); later turns carry the history into the prompt. The turn's
        state is staged and committed only when the turn succeeds, so a
        failed turn leaves the chat as it was."""
        from teochat_torch.config import GenerationConfig

        new_images = list(image_paths)
        images_all = self.images + new_images
        ts_all = self.timestamps + list(timestamps)
        if ts_all and len(ts_all) != len(images_all):
            raise ValueError(
                f"timestamps must cover every frame of the conversation "
                f"(got {len(ts_all)} timestamps for {len(images_all)} frames); "
                "either pass one per frame on every turn or never pass any"
            )
        frames_all = self._frames
        if new_images:
            new_frames = self.processor.preprocess(new_images)["pixel_values"]
            frames_all = (new_frames if frames_all is None
                          else np.concatenate([frames_all, new_frames], axis=0))
        # the chronological sort over the cached preprocessed frames, so that
        # build_request's own sort is a no-op and no frame is preprocessed again
        if ts_all:
            order = _chronological(ts_all)
            images_sorted = [images_all[i] for i in order]
            ts_sorted = [ts_all[i] for i in order]
            frames_sorted = frames_all[np.asarray(order)] if frames_all is not None else None
        else:
            images_sorted, ts_sorted, frames_sorted = images_all, ts_all, frames_all

        input_ids, pixel_values, stop_str, text = build_request(
            text, images_sorted, self.tokenizer, self.processor,
            conv_mode=self.conv_mode, timestamps=ts_sorted, bbox=bbox,
            history=self.history, first_turn=self._first_turn, pixel_values=frames_sorted,
            mm_use_im_start_end=getattr(getattr(self.model, "cfg", None),
                                        "mm_use_im_start_end", False),
        )
        gen = GenerationConfig(
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            do_sample=temperature > 0,
            stop_strings=(stop_str,),
            speculative_k=speculative_k,
        )
        if self._session is not None:
            out_ids = self._session.generate(input_ids, pixel_values, gen)
        else:
            out_ids = self.model.generate([input_ids], pixel_values, gen)[0]
        response = self.tokenizer.decode(out_ids).replace("</s>", "").strip()
        # commit the turn
        self.images = images_all
        self.timestamps = ts_all
        self._frames = frames_all
        self._first_turn = False
        self.history.append((text, response))
        return {"response": response, "bboxes": extract_bboxes(response)}


def build_demo(*args, **kwargs):
    """The Gradio app: see serve/demo.py (gradio is optional)."""
    from teochat_torch.serve.demo import build_demo as _build

    return _build(*args, **kwargs)
