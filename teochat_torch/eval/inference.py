"""Inference core: prompt assembly + generation for the eval/serve harnesses.

The port's own copy of teochat_tpu/eval/inference.py (itself an API-parity
rebuild of reference videollava/eval/inference.py): `replace_video_token`
(:11-20), `run_inference_single` (:23-77), `extract_bboxes` (:80-85),
`run_inference` (:88-137), and the JAX package's `run_inference_batched`.
`model` is a `teochat_torch.models.teochat.TEOChat`; `rng` is a
torch.Generator on its device or an int seed.
"""

from __future__ import annotations

import re
from concurrent.futures import ThreadPoolExecutor
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
        # models trained with the wrap expect it at inference too
        from teochat_torch.vision_tokenizer import wrap_image_tokens

        prompt = wrap_image_tokens(prompt)
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
    """Dataset loop (reference inference.py:88-137). batch_size > 1 routes to
    the batched loop."""
    if batch_size > 1:
        return run_inference_batched(
            dataset, model, tokenizer, processor, prompt_strategy,
            chronological_prefix, conv_mode, temperature, max_new_tokens,
            dataset_name=dataset_name, batch_size=batch_size, progress=progress,
            speculative_k=speculative_k,
        )
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


def run_inference_batched(
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
    batch_size: int = 8,
    progress: bool = True,
    speculative_k: int = 0,
) -> List[Dict]:
    """Batched eval: examples sorted by fused length into batches of
    `batch_size` (fewer pad tokens a batch), each batch's rows decoded
    together by one `generate` with the first row's stop string; the frames
    of the next batch are preprocessed on a worker thread while the current
    one generates. Outputs come back in dataset order."""
    examples = list(dataset)
    prepped = []
    for idx, example in enumerate(examples):
        prompt, image_paths, stop_str = _build_prompt(
            example["conversations"][0]["value"], example["video"], conv_mode,
            example["timestamp"], prompt_strategy, chronological_prefix,
            mm_use_im_start_end=getattr(
                getattr(model, "cfg", None), "mm_use_im_start_end", False
            ),
        )
        ids = tokenizer_image_token(prompt, tokenizer, IMAGE_TOKEN_INDEX)
        n_frames = sum(1 for t in ids if t == IMAGE_TOKEN_INDEX)
        fused = len(ids) + n_frames * (model.tokens_per_frame - 1)
        prepped.append((idx, ids, image_paths, stop_str, fused))
    prepped.sort(key=lambda p: p[4])

    gen_base = dict(
        max_new_tokens=max_new_tokens,
        temperature=temperature,
        do_sample=temperature > 0,
        speculative_k=speculative_k,
    )
    responses: Dict[int, str] = {}
    batches = [prepped[i : i + batch_size] for i in range(0, len(prepped), batch_size)]

    def _prep(batch):
        frames = [processor.preprocess(list(b[2]))["pixel_values"] for b in batch]
        return np.concatenate(frames, axis=0) if frames else None

    iterator = range(len(batches))
    if progress:
        from tqdm import tqdm

        iterator = tqdm(iterator)
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(_prep, batches[0]) if batches else None
        for i in iterator:
            batch = batches[i]
            pixel_values = fut.result()
            if i + 1 < len(batches):
                fut = pool.submit(_prep, batches[i + 1])
            ids_list = [b[1] for b in batch]
            gen = GenerationConfig(stop_strings=(batch[0][3],), **gen_base)
            outs = model.generate(ids_list, pixel_values, gen)
            for (idx, _, _, _, _), out_ids in zip(batch, outs):
                responses[idx] = tokenizer.decode(out_ids).replace("</s>", "").strip()

    return [
        _collect_output(example, responses[i], dataset_name)
        for i, example in enumerate(examples)
    ]
