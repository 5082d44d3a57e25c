"""Eval driver: 17-split TEOChatlas harness with result-JSON caching.

The port's own copy of teochat_tpu/eval/eval.py, a rebuild of reference
videollava/eval/eval.py: dataset-name -> HF-split registry (:90-108),
classification/detection metric dispatch (:60-88), result caching keyed on
model + prompt args with inference skipped when the JSON exists (:111-141),
`load_model` (:15-34, over the port's builder; no separate video tower is
built), and the CLI (:180-199) with the reference's defaults (temperature
0.2, max_new_tokens 256, conv v1, interleave strategy). A split is read
with `datasets.load_dataset` unless its examples are passed as `dataset=`;
`batch_size > 1` runs the batched loop (inference.py::run_inference_batched).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

from teochat_torch.eval.classification import classification_metrics
from teochat_torch.eval.detection import detection_metrics
from teochat_torch.eval.inference import run_inference
from teochat_torch.mm_utils import get_model_name_from_path

CLASSIFICATION_DATASETS = [
    "fmow_high_res", "fmow_low_res", "abcd", "cdvqa", "aid", "ucm", "lrben", "hrben",
]

DETECTION_DATASETS = [
    "xbd_loc", "xbd_dmg_cls", "s2_det", "xbd_sre_qa_rqa", "s2_sre_qa", "s2_rqa",
    "qfabric_rqa2", "qfabric_rqa5_rtqa5", "qfabric_tre_rtqa",
]

DATASET_NAME_TO_HF_SPLIT = {
    "fmow_high_res": "fMoW_High_Res",
    "fmow_low_res": "fMoW_Low_Res",
    "abcd": "ABCD",
    "cdvqa": "CDVQA",
    "aid": "AID",
    "ucm": "UCMerced",
    "lrben": "LRBEN",
    "hrben": "HRBEN",
    "xbd_loc": "xBD_Change_Detection_Localization",
    "xbd_dmg_cls": "xBD_Change_Detection_Classification",
    "s2_det": "S2Looking_Change_Detection",
    "xbd_sre_qa_rqa": "xBD_SRE_QA_RQA",
    "s2_sre_qa": "S2Looking_SRE_QA",
    "s2_rqa": "S2Looking_RQA",
    "qfabric_rqa2": "QFabric_RQA2",
    "qfabric_rqa5_rtqa5": "QFabric_RQA5_RTQA5",
    "qfabric_tre_rtqa": "QFabric_TRE_RTQA",
}


def load_model(model_path, model_base=None, load_8bit=False, load_4bit=False,
               cache_dir=None, device=None, vision_path=None, load_int4=False,
               quantize_vision=False):
    """(tokenizer, model, image_processor) — reference eval.py:15-34."""
    from teochat_torch.builder import load_pretrained_model

    tokenizer, model, processor, _ = load_pretrained_model(
        model_path, model_base, get_model_name_from_path(model_path),
        load_8bit=load_8bit, load_4bit=load_4bit, load_int4=load_int4,
        device=device, cache_dir=cache_dir, vision_path=vision_path,
        quantize_vision=quantize_vision,
    )
    return tokenizer, model, processor["image"]


def eval(
    dataset_name: str,
    model_path: str,
    model_base: Optional[str] = None,
    load_8bit: bool = False,
    load_4bit: bool = False,
    load_int4: bool = False,
    quantize_vision: bool = False,
    cache_dir: Optional[str] = None,
    data_cache_dir: Optional[str] = None,
    out_name: Optional[str] = None,
    out_dir: Optional[str] = None,
    prompt_strategy: Optional[str] = "interleave",
    chronological_prefix: bool = True,
    conv_mode: str = "v1",
    device: Optional[str] = None,
    force_rerun: bool = False,
    temperature: float = 0.2,
    max_new_tokens: int = 256,
    batch_size: int = 1,
    vision_path: Optional[str] = None,
    speculative_k: int = 0,
    dataset=None,
    model_bundle=None,
):
    """Run (or load cached) inference for one split and compute its metrics.

    `dataset` / `model_bundle` allow injecting a pre-loaded dataset and
    (tokenizer, model, processor) — used by tests and batch sweeps.
    """
    args = dict(prompt_strategy=prompt_strategy, chronological_prefix=chronological_prefix)

    if dataset_name in CLASSIFICATION_DATASETS:
        eval_metrics_fn = classification_metrics
    elif dataset_name in DETECTION_DATASETS:
        eval_metrics_fn = detection_metrics
    else:
        raise ValueError(f"Unsupported dataset: {dataset_name}")

    hf_split = DATASET_NAME_TO_HF_SPLIT[dataset_name]

    out_dir = Path(out_dir) if out_dir is not None else Path("results")
    out_subdir = out_dir / dataset_name
    out_subdir.mkdir(parents=True, exist_ok=True)

    if out_name is None:
        out_name = f"{get_model_name_from_path(model_path)}.json"
    if ".json" not in out_name:
        out_name = f"{out_name}.json"
    for arg in ("prompt_strategy", "chronological_prefix"):
        if args[arg] is not None:
            out_name = out_name.replace(".json", f"_{arg}_{args[arg]}.json")
    out_path = out_subdir / out_name

    if out_path.exists() and not force_rerun:
        print(f"Output file {out_path} already exists. Computing metrics without running inference.")
        with open(out_path) as f:
            outputs = json.load(f)
    else:
        if model_bundle is not None:
            tokenizer, model, processor = model_bundle
        else:
            tokenizer, model, processor = load_model(
                model_path, model_base, load_8bit=load_8bit, load_4bit=load_4bit,
                load_int4=load_int4, cache_dir=cache_dir, device=device,
                vision_path=vision_path, quantize_vision=quantize_vision,
            )
        if dataset is None:
            from datasets import load_dataset

            dataset = load_dataset(
                "jirvin16/TEOChatlas", split=f"eval_{hf_split}",
                cache_dir=data_cache_dir, trust_remote_code=True,
            )
        outputs = run_inference(
            dataset, model, tokenizer, processor, prompt_strategy,
            chronological_prefix, conv_mode, temperature, max_new_tokens,
            dataset_name=dataset_name, batch_size=batch_size,
            speculative_k=speculative_k,
        )
        print(f"Saving outputs to {out_path}")
        with open(out_path, "w") as f:
            json.dump(outputs, f, indent=4, default=int)

    metrics = eval_metrics_fn(outputs, dataset_name=dataset_name)
    print(f"Metrics for dataset {dataset_name}:")
    for key, value in metrics.items():
        print(f"\t{key}: {value}")
    return metrics


def _str_or_none(value):
    return None if value == "" or value.lower() == "none" else value


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_name", type=str, required=True)
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--model_base", type=_str_or_none, default=None)
    parser.add_argument("--load_8bit", action="store_true")
    parser.add_argument("--load_4bit", action="store_true")
    parser.add_argument("--load_int4", action="store_true")
    parser.add_argument("--quantize_vision", action="store_true",
                        help="w8a8 int8 vision tower (per-token int8 activations "
                             "on the int8 tensor cores; close to, not equal to, bf16)")
    parser.add_argument("--cache_dir", type=str, default=None)
    parser.add_argument("--data_cache_dir", type=str, default=None)
    parser.add_argument("--out_name", type=str, default=None)
    parser.add_argument("--out_dir", type=str, default=None)
    parser.add_argument("--prompt_strategy", type=str, default="interleave")
    parser.add_argument("--chronological_prefix", action="store_true")
    parser.add_argument("--device", type=str, default=None)
    parser.add_argument("--force_rerun", action="store_true")
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--max_new_tokens", type=int, default=256)
    parser.add_argument("--batch_size", type=int, default=1)
    # prompt-lookup speculative decoding
    parser.add_argument("--speculative_k", type=int, default=0)
    parser.add_argument("--vision_path", type=str, default=None)
    args = parser.parse_args(argv)
    eval(**vars(args))


if __name__ == "__main__":
    main()
