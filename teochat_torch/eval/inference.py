"""Inference core: prompt assembly + generation for the eval/serve harnesses.

The port's own copy of teochat_tpu/eval/inference.py (itself an API-parity
rebuild of reference videollava/eval/inference.py): `replace_video_token`
(:11-20), `run_inference_single` (:23-77), `extract_bboxes` (:80-85),
`run_inference` (:88-137). `model` is a `teochat_torch.models.teochat.TEOChat`;
`rng` is a torch.Generator on its device or an int seed. Not ported yet:
`run_inference_batched` (batch_size > 1) and the `mm_use_im_start_end`
wrap; each raises where it is asked for.
"""

from __future__ import annotations

import re
from datetime import datetime
from typing import Dict, List, Optional, Sequence

import numpy as np

from teochat_torch.config import GenerationConfig
from teochat_torch.constants import (
    DEFAULT_IMAGE_TOKEN,
    DEFAULT_VIDEO_TOKEN,
    IMAGE_TOKEN_INDEX,
)
from teochat_torch.conversation import SeparatorStyle, conv_templates
from teochat_torch.mm_utils import tokenizer_image_token


def replace_video_token(prompt: str, image_paths: Sequence, prompt_strategy: Optional[str]) -> str:
    if prompt_strategy is None:
        vid = DEFAULT_IMAGE_TOKEN * len(image_paths)
    elif prompt_strategy == "interleave":
        vid = "".join(
            f"Image {i + 1}: {DEFAULT_IMAGE_TOKEN}" for i in range(len(image_paths))
        )
    else:
        raise ValueError(f"Unknown prompt strategy: {prompt_strategy}")
    return prompt.replace(DEFAULT_VIDEO_TOKEN, vid)


def _build_prompt(
    inp: str,
    image_paths: Sequence,
    conv_mode: str,
    timestamps: Sequence[str],
    prompt_strategy: Optional[str],
    chronological_prefix: bool,
    mm_use_im_start_end: bool = False,
):
    """Returns (prompt, sorted_image_paths, stop_str)."""
    conv = conv_templates[conv_mode].copy()
    conv.append_message(conv.roles[0], inp)
    conv.append_message(conv.roles[1], None)
    prompt = conv.get_prompt()

    if chronological_prefix:
        prompt = prompt.replace("times:", "times in chronological order:")

    if len(timestamps) > 0:
        image_paths, timestamps = zip(
            *sorted(
                zip(image_paths, timestamps),
                key=lambda t: datetime.strptime(t[1], "%Y-%m-%d"),
            )
        )

    prompt = replace_video_token(prompt, image_paths, prompt_strategy)
    if mm_use_im_start_end:
        raise NotImplementedError("mm_use_im_start_end is not ported yet")
    stop_str = conv.sep if conv.sep_style != SeparatorStyle.TWO else conv.sep2
    return prompt, list(image_paths), stop_str


def run_inference_single(
    model,
    processor,
    tokenizer,
    inp: str,
    image_paths: Sequence,
    conv_mode: str = "v1",
    timestamps: Sequence[str] = (),
    prompt_strategy: Optional[str] = "interleave",
    chronological_prefix: bool = True,
    temperature: float = 0.2,
    max_new_tokens: int = 256,
    rng=None,
    speculative_k: int = 0,
) -> str:
    """Generate a response for one example (reference inference.py:23-77).

    `speculative_k` > 0 enables prompt-lookup speculative decoding for greedy
    runs (temperature 0) — token-identical outputs, fewer decode steps."""
    prompt, image_paths, stop_str = _build_prompt(
        inp, image_paths, conv_mode, timestamps, prompt_strategy,
        chronological_prefix,
        mm_use_im_start_end=getattr(
            getattr(model, "cfg", None), "mm_use_im_start_end", False
        ),
    )
    pixel_values = processor.preprocess(list(image_paths))["pixel_values"]
    input_ids = tokenizer_image_token(prompt, tokenizer, IMAGE_TOKEN_INDEX)

    gen = GenerationConfig(
        max_new_tokens=max_new_tokens,
        temperature=temperature,
        do_sample=temperature > 0,
        stop_strings=(stop_str,),
        speculative_k=speculative_k,
    )
    out_ids = model.generate([input_ids], pixel_values, gen, rng=rng)[0]
    text = tokenizer.decode(out_ids)
    return text.replace("</s>", "").strip()


def extract_bboxes(bbox_str: str) -> List[List[int]]:
    pattern = re.compile(r"\[(\d+), (\d+), (\d+), (\d+)\]")
    return [list(map(int, m.groups())) for m in pattern.finditer(bbox_str)]


def _collect_output(example, response: str, dataset_name: Optional[str]) -> Dict:
    output = {
        "response": response,
        "ground_truth": example["conversations"][1]["value"],
        "task": example["task"],
    }
    polygon = example.get("polygon", None)
    if polygon is not None:
        output["polygon"] = polygon
    elif dataset_name in (
        "xbd_loc", "xbd_dmg_cls", "s2_det", "qfabric_rqa2", "qfabric_rqa5",
        "xbd_sre_qa_rqa", "s2_sre_qa", "s2_rqa",
    ):
        raise ValueError(
            f"Polygons not found for dataset {dataset_name}. The TEOChatlas "
            "dataset was updated to include these polygons on 25 Mar 2025; "
            "re-download the json files for these splits."
        )
    input_bboxes = extract_bboxes(example["conversations"][0]["value"])
    output_bboxes = extract_bboxes(example["conversations"][1]["value"])
    if input_bboxes:
        output["input_bboxes"] = input_bboxes
    if output_bboxes:
        output["output_bboxes"] = output_bboxes
    return output


def run_inference(
    dataset,
    model,
    tokenizer,
    processor,
    prompt_strategy: Optional[str],
    chronological_prefix: bool,
    conv_mode: str,
    temperature: float,
    max_new_tokens: int,
    dataset_name: Optional[str] = None,
    batch_size: int = 1,
    progress: bool = True,
    speculative_k: int = 0,
) -> List[Dict]:
    """Dataset loop (reference inference.py:88-137), one example at a time."""
    if batch_size > 1:
        raise NotImplementedError("run_inference_batched is not ported yet")
    iterator = dataset
    if progress:
        from tqdm import tqdm

        iterator = tqdm(dataset)
    outputs = []
    for example in iterator:
        response = run_inference_single(
            model, processor, tokenizer,
            example["conversations"][0]["value"], example["video"],
            conv_mode=conv_mode, timestamps=example["timestamp"],
            prompt_strategy=prompt_strategy,
            chronological_prefix=chronological_prefix,
            temperature=temperature, max_new_tokens=max_new_tokens,
            speculative_k=speculative_k,
        )
        outputs.append(_collect_output(example, response, dataset_name))
    return outputs
