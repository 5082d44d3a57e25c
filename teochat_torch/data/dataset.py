"""Training data pipeline (jax-free copy of teochat_tpu/data/dataset.py).

The JAX module imports jax through `teochat_tpu.models.fusion`, so the
parts the training path runs are kept here, tested equal to the originals
array for array: `DataArguments`, `preprocess_multimodal`, `preprocess`
with its v1 branch (the LLaMA recipe's template), `LazySupervisedDataset`,
`TEOChatCollator` (which builds the port's FusionPlan) and
`make_supervised_data_module`. The conversation templates, constants,
`tokenizer_image_token`, `order_pick_k` and the sampler are this package's
own copies of the JAX package's host modules. Every template's preprocessor
is ported (v1, llama_2, mpt, plain), and so is `mm_use_im_start_end`'s
`<im_start><image><im_end>` wrap (vision_tokenizer.py).
"""

from __future__ import annotations

import copy
import random
from dataclasses import dataclass
from datetime import datetime
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from teochat_torch import conversation as conversation_lib
from teochat_torch.constants import (
    DEFAULT_IMAGE_TOKEN,
    DEFAULT_VIDEO_TOKEN,
    IGNORE_INDEX,
    MAX_IMAGE_LENGTH,
    MAX_VIDEO_LENGTH,
)
from teochat_torch.mm_utils import tokenizer_image_token
from teochat_torch.utils import order_pick_k
from teochat_torch.vision_tokenizer import wrap_image_tokens
from teochat_torch.models.fusion import build_fusion_plan
from teochat_torch.models.teochat import round_to_bucket

default_conversation = conversation_lib.conv_templates["v1"]


@dataclass
class DataArguments:
    """The fields of the reference DataArguments (train.py:79-100) this path reads."""

    data_name: str = "jirvin16/TEOChatlas"
    data_split: str = "train"
    data_cache_dir: Optional[str] = None
    # accepted for flag parity: this dataset is always lazy
    lazy_preprocess: bool = True
    is_multimodal: bool = True
    image_aspect_ratio: Optional[str] = None
    prompt_strategy: Optional[str] = "interleave"
    chronological_prefix: bool = True
    mm_use_im_start_end: bool = False
    video_as_image_list: bool = True
    num_frames: int = 8
    image_processor: Any = None
    video_processor: Any = None


def set_default_conversation(version: str) -> None:
    global default_conversation
    default_conversation = conversation_lib.conv_templates.get(
        version, conversation_lib.conv_templates["v1"]
    )


def preprocess_multimodal(
    sources: Sequence[List[Dict]],
    data_args: DataArguments,
    num_video_images: int = 0,
) -> Sequence[List[Dict]]:
    if not data_args.is_multimodal:
        return sources
    for source in sources:
        for sentence in source:
            value = sentence["value"]
            if value.startswith(DEFAULT_IMAGE_TOKEN) or value.startswith(DEFAULT_VIDEO_TOKEN):
                if "mmtag" in default_conversation.version:
                    value = value.replace(
                        DEFAULT_IMAGE_TOKEN, "<Image>" + DEFAULT_IMAGE_TOKEN + "</Image>"
                    )
                n_img = value.count(DEFAULT_IMAGE_TOKEN)
                if n_img > MAX_IMAGE_LENGTH:
                    value = value.replace(
                        DEFAULT_IMAGE_TOKEN * n_img, DEFAULT_IMAGE_TOKEN * MAX_IMAGE_LENGTH
                    ).strip()
                if value.count(DEFAULT_VIDEO_TOKEN) > MAX_VIDEO_LENGTH:
                    raise ValueError(f"too many <video> tokens: {value}")

            if data_args.chronological_prefix:
                value = value.replace("times:", "times in chronological order:")

            if data_args.prompt_strategy is None:
                replace_token = DEFAULT_IMAGE_TOKEN
                vid_replace_token = DEFAULT_IMAGE_TOKEN * num_video_images
            elif data_args.prompt_strategy == "interleave":
                replace_token = f"Image: {DEFAULT_IMAGE_TOKEN}"
                vid_replace_token = "".join(
                    f"Image {i + 1}: {DEFAULT_IMAGE_TOKEN}" for i in range(num_video_images)
                )
            else:
                raise ValueError(f"Unknown prompt strategy: {data_args.prompt_strategy}")

            value = value.replace(DEFAULT_IMAGE_TOKEN, replace_token)
            value = value.replace(DEFAULT_VIDEO_TOKEN, vid_replace_token)
            if getattr(data_args, "mm_use_im_start_end", False):
                # at each <image>, so interleave's "Image {i}: " stays outside
                value = wrap_image_tokens(value)
            sentence["value"] = value
    return sources


def _render_conversations(sources, conv) -> List[str]:
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    conversations = []
    for i, source in enumerate(sources):
        if roles[source[0]["from"]] != conv.roles[0]:
            source = source[1:]
        conv.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == conv.roles[j % 2], f"{i}"
            conv.append_message(role, sentence["value"])
        conversations.append(conv.get_prompt())
    return conversations


def _tokenize(text: str, tokenizer, has_image: bool) -> List[int]:
    if has_image:
        return tokenizer_image_token(text, tokenizer)
    return list(tokenizer(text).input_ids)


def _mask_rounds_two_style(
    conversations: List[str],
    input_ids: List[List[int]],
    tokenizer,
    conv,
    sep: str,
    has_image: bool,
    instruction_offset: int = -2,
) -> List[List[int]]:
    """Mask everything but the assistant's answers (reference preprocess_v1)."""
    model_max = getattr(tokenizer, "model_max_length", 10 ** 9)
    pad_id = getattr(tokenizer, "pad_token_id", 0) or 0
    targets = []
    for conversation, ids in zip(conversations, input_ids):
        target = list(ids)
        total_len = sum(1 for t in ids if t != pad_id)
        rounds = conversation.split(conv.sep2)
        cur_len = 1
        target[:cur_len] = [IGNORE_INDEX]
        for rou in rounds:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = len(_tokenize(rou, tokenizer, has_image))
            instruction_len = len(_tokenize(parts[0], tokenizer, has_image)) + instruction_offset
            target[cur_len : cur_len + instruction_len] = [IGNORE_INDEX] * min(
                instruction_len, max(len(target) - cur_len, 0)
            )
            cur_len += round_len
        target[cur_len:] = [IGNORE_INDEX] * max(len(target) - cur_len, 0)
        if cur_len < model_max and cur_len != total_len:
            target = [IGNORE_INDEX] * len(target)
            print(f"WARNING: tokenization mismatch: {cur_len} vs. {total_len}. (ignored)")
        targets.append(target)
    return targets


def preprocess_v1(sources, tokenizer, has_image: bool = False) -> Dict[str, List[List[int]]]:
    conv = default_conversation.copy()
    conversations = _render_conversations(sources, conv)
    assert conv.sep_style == conversation_lib.SeparatorStyle.TWO
    input_ids = [_tokenize(c, tokenizer, has_image) for c in conversations]
    sep = conv.sep + conv.roles[1] + ": "
    labels = _mask_rounds_two_style(
        conversations, input_ids, tokenizer, conv, sep, has_image
    )
    return dict(input_ids=input_ids, labels=labels)


def preprocess_llama_2(sources, tokenizer, has_image: bool = False) -> Dict:
    conv = default_conversation.copy()
    conversations = _render_conversations(sources, conv)
    assert conv.sep_style == conversation_lib.SeparatorStyle.LLAMA_2
    input_ids = [_tokenize(c, tokenizer, has_image) for c in conversations]
    labels = _mask_rounds_two_style(
        conversations, input_ids, tokenizer, conv, "[/INST] ", has_image
    )
    return dict(input_ids=input_ids, labels=labels)


def preprocess_mpt(sources, tokenizer) -> Dict:
    conv = default_conversation.copy()
    conversations = _render_conversations(sources, conv)
    assert conv.sep_style == conversation_lib.SeparatorStyle.MPT
    input_ids = [_tokenize(c, tokenizer, True) for c in conversations]
    sep = conv.sep + conv.roles[1]
    model_max = getattr(tokenizer, "model_max_length", 10 ** 9)
    pad_id = getattr(tokenizer, "pad_token_id", 0) or 0
    targets = []
    for conversation, ids in zip(conversations, input_ids):
        target = list(ids)
        total_len = sum(1 for t in ids if t != pad_id)
        rounds = conversation.split(conv.sep)
        re_rounds = [conv.sep.join(rounds[:3])]
        for idx in range(3, len(rounds), 2):
            re_rounds.append(conv.sep.join(rounds[idx : idx + 2]))
        cur_len = 0
        for rou in re_rounds:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = len(_tokenize(rou, tokenizer, True)) + len(
                _tokenize(conv.sep, tokenizer, True)
            )
            instruction_len = len(_tokenize(parts[0], tokenizer, True))
            target[cur_len : cur_len + instruction_len] = [IGNORE_INDEX] * min(
                instruction_len, max(len(target) - cur_len, 0)
            )
            cur_len += round_len
        target[cur_len:] = [IGNORE_INDEX] * max(len(target) - cur_len, 0)
        if cur_len < model_max and cur_len != total_len:
            target = [IGNORE_INDEX] * len(target)
            print(f"WARNING: tokenization mismatch: {cur_len} vs. {total_len}. (ignored)")
        targets.append(target)
    return dict(input_ids=input_ids, labels=targets)


def preprocess_plain(sources, tokenizer) -> Dict:
    conversations = []
    for source in sources:
        assert len(source) == 2
        assert DEFAULT_IMAGE_TOKEN in source[0]["value"]
        source[0]["value"] = DEFAULT_IMAGE_TOKEN
        conversations.append(
            source[0]["value"] + source[1]["value"] + default_conversation.sep
        )
    input_ids = [_tokenize(c, tokenizer, True) for c in conversations]
    targets = [list(ids) for ids in input_ids]
    for target, source in zip(targets, sources):
        tokenized_len = len(_tokenize(source[0]["value"], tokenizer, True))
        target[:tokenized_len] = [IGNORE_INDEX] * tokenized_len
    return dict(input_ids=input_ids, labels=targets)


def preprocess(sources, tokenizer, has_image: bool = False) -> Dict:
    """Template dispatcher (reference train.py:619-664)."""
    style = default_conversation.sep_style
    if style == conversation_lib.SeparatorStyle.PLAIN:
        return preprocess_plain(sources, tokenizer)
    if style == conversation_lib.SeparatorStyle.LLAMA_2:
        return preprocess_llama_2(sources, tokenizer, has_image=has_image)
    if default_conversation.version.startswith("v1"):
        return preprocess_v1(sources, tokenizer, has_image=has_image)
    if default_conversation.version == "mpt":
        return preprocess_mpt(sources, tokenizer)
    raise ValueError(f"no preprocessor for template {default_conversation.version}")


class LazySupervisedDataset:
    """TEOChatlas supervised dataset (reference train.py:681-837).

    `dataset` may be an HF dataset or a list of example dicts (tests). Images
    may be file paths, PIL images, or numpy arrays.
    """

    def __init__(self, tokenizer, data_args: DataArguments, dataset=None):
        self.tokenizer = tokenizer
        self.data_args = data_args
        if dataset is None:
            from datasets import load_dataset

            dataset = load_dataset(
                data_args.data_name, split=data_args.data_split,
                cache_dir=data_args.data_cache_dir,
            )
        self.list_data_dict = dataset

    def __len__(self) -> int:
        return len(self.list_data_dict)

    @property
    def modality_lengths(self) -> List[int]:
        out = []
        for sample in self.list_data_dict:
            cur_len = sum(len(conv["value"].split()) for conv in sample["conversations"])
            out.append(cur_len if ("image" in sample or "video" in sample) else -cur_len)
        return out

    def _load_frames(self, files) -> List[np.ndarray]:
        proc = self.data_args.image_processor
        if self.data_args.image_aspect_ratio == "pad":
            # square-pad with the CLIP mean colour before resize/crop
            from teochat_torch.data.processing import _to_pil
            from teochat_torch.mm_utils import expand2square

            background = tuple(int(x * 255) for x in proc.image_mean)
            return [proc.preprocess(expand2square(_to_pil(f), background))["pixel_values"][0]
                    for f in files]
        return [proc.preprocess(f)["pixel_values"][0] for f in files]

    def __getitem__(self, i: int) -> Dict:
        # data-error tolerance: resample up to 64 times, then raise
        last_err: Optional[Exception] = None
        for _ in range(64):
            try:
                return self._get_one(i)
            except Exception as e:
                print(f"Error with {e}")
                last_err = e
                i = random.randint(0, len(self) - 1)
        raise RuntimeError("64 consecutive sample loads failed; dataset looks broken") from last_err

    def _get_one(self, i: int) -> Dict:
        sample = self.list_data_dict[i]
        sources = [sample]
        image: List[np.ndarray] = []

        if "video" in sample and sample["video"] is not None:
            image_files = sample["video"]
            if not isinstance(image_files, list):
                raise ValueError("Found single image but list of images expected")
            image_files, indices = order_pick_k(image_files, MAX_IMAGE_LENGTH)
            timestamps = sample.get("timestamp") or []
            if len(timestamps) > 0:
                if indices is not None:
                    timestamps = [timestamps[j] for j in indices]
                image_files, timestamps = zip(
                    *sorted(
                        zip(image_files, timestamps),
                        key=lambda t: datetime.strptime(t[1], "%Y-%m-%d"),
                    )
                )
            image = self._load_frames(list(image_files))
            srcs = preprocess_multimodal(
                copy.deepcopy([e["conversations"] for e in sources]),
                self.data_args,
                len(image),
            )
            data_dict = preprocess(srcs, self.tokenizer, has_image=True)
        elif "image" in sample and sample["image"] is not None:
            image_files = sample["image"]
            if not isinstance(image_files, list):
                image_files = [image_files]
            image_files, _ = order_pick_k(image_files, MAX_IMAGE_LENGTH)
            image = self._load_frames(image_files)
            srcs = preprocess_multimodal(
                copy.deepcopy([e["conversations"] for e in sources]),
                self.data_args,
                1,
            )
            data_dict = preprocess(srcs, self.tokenizer, has_image=True)
        else:
            srcs = copy.deepcopy([e["conversations"] for e in sources])
            data_dict = preprocess(srcs, self.tokenizer, has_image=False)

        out = dict(input_ids=data_dict["input_ids"][0], labels=data_dict["labels"][0])
        if image:
            out["image"] = image
        # text-only samples contribute no frames (the fusion plan consumes
        # exactly the frames of the sentinels, in flat batch order)
        return out


@dataclass
class TEOChatCollator:
    """Batch -> (FusionPlan, pixel_values): the plan of the flat frame list,
    padded to a sequence bucket, and the frames padded to a frame bucket."""

    tokenizer: Any
    tokens_per_frame: int = 256
    max_length: int = 3072
    seq_buckets: Sequence[int] = (256, 512, 1024, 2048, 3072, 4352)
    frame_buckets: Sequence[int] = (1, 2, 4, 8, 16, 32, 64)

    def __call__(self, instances: Sequence[Dict]):
        input_ids = [list(inst["input_ids"]) for inst in instances]
        labels = [list(inst["labels"]) for inst in instances]

        frames: List[np.ndarray] = []
        for inst in instances:
            for f in inst.get("image", []):
                frames.append(np.asarray(f))

        fused_max = max(
            len(ids)
            + sum(1 for t in ids if t < 0) * (self.tokens_per_frame - 1)
            for ids in input_ids
        )
        pad_to = round_to_bucket(min(fused_max, self.max_length), self.seq_buckets)
        plan = build_fusion_plan(
            input_ids,
            labels=labels,
            tokens_per_frame=self.tokens_per_frame,
            max_length=self.max_length,
            pad_to=pad_to,
        )
        n = len(frames)
        n_pad = round_to_bucket(max(n, 1), self.frame_buckets)
        if frames:
            pixel_values = np.stack(frames, axis=0)
        else:
            pixel_values = np.zeros((0, 3, 224, 224), np.float32)
        if n_pad != n:
            shape = (n_pad - n,) + tuple(pixel_values.shape[1:] or (3, 224, 224))
            pixel_values = np.concatenate(
                [pixel_values, np.zeros(shape, pixel_values.dtype)], axis=0
            )
        return plan, pixel_values


def make_supervised_data_module(tokenizer, data_args: DataArguments,
                                tokens_per_frame: int = 256,
                                max_length: int = 3072,
                                dataset=None) -> Dict:
    train_dataset = LazySupervisedDataset(tokenizer, data_args, dataset=dataset)
    collator = TEOChatCollator(
        tokenizer, tokens_per_frame=tokens_per_frame, max_length=max_length
    )
    return dict(train_dataset=train_dataset, eval_dataset=None, data_collator=collator)
