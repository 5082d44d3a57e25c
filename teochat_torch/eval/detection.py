"""Detection metrics — pixel confusion-matrix evaluation over rasterized masks.

Math-exact port of reference videollava/eval/detection.py (the xBD/S2Looking/
QFabric paper-number source): `Evaluator` (:12-113), `evaluate_masks`
(:161-217), `change_detection_classification` (:220-298), and the per-dataset
task dispatch (:301-412). Reference quirks preserved where they affect numbers
(e.g. out-of-vocab predictions contribute fn=0 because gt_msk is still zeroed,
:240-244); the reference's `dataset_ame` NameError in an error branch
(:344) is fixed to a proper message.

The port's own copy of teochat_tpu/eval/detection.py.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

from teochat_torch.eval.classification import classification_metrics, get_string_cleaner
from teochat_torch.eval.geometry import boxes_to_wkt, create_mask


class Evaluator:
    """Accumulating pixel confusion matrix + derived metrics."""

    def __init__(self, num_class: int):
        self.num_class = num_class
        self.confusion_matrix = np.zeros((num_class,) * 2, dtype=np.longlong)

    def Pixel_Accuracy(self) -> float:
        return np.diag(self.confusion_matrix).sum() / self.confusion_matrix.sum()

    def Pixel_Accuracy_Class(self):
        acc = np.diag(self.confusion_matrix) / (self.confusion_matrix.sum(axis=1) + 1e-7)
        return np.nanmean(acc), acc

    def Pixel_Precision_Rate(self) -> float:
        assert self.confusion_matrix.shape[0] == 2
        cm = self.confusion_matrix
        return cm[1, 1] / (cm[0, 1] + cm[1, 1])

    def Pixel_Recall_Rate(self) -> float:
        assert self.confusion_matrix.shape[0] == 2
        cm = self.confusion_matrix
        return cm[1, 1] / (cm[1, 0] + cm[1, 1])

    def Pixel_F1_score(self) -> float:
        rec, pre = self.Pixel_Recall_Rate(), self.Pixel_Precision_Rate()
        return 2 * rec * pre / (rec + pre)

    def _per_class(self):
        tps = np.diag(self.confusion_matrix)[1:]
        fns = np.sum(self.confusion_matrix, axis=1)[1:] - tps
        fps = np.sum(self.confusion_matrix, axis=0)[1:] - tps
        return tps, fns, fps

    def Damage_F1_score(self):
        tps, fns, fps = self._per_class()
        precisions = tps / (tps + fps + 1e-7)
        recalls = tps / (tps + fns + 1e-7)
        return 2 * (precisions * recalls) / (precisions + recalls + 1e-7)

    def Mean_Intersection_over_Union(self) -> float:
        cm = self.confusion_matrix
        iou = np.diag(cm) / (cm.sum(axis=1) + cm.sum(axis=0) - np.diag(cm) + 1e-7)
        return np.nanmean(iou)

    def Intersection_over_Union(self) -> float:
        assert self.confusion_matrix.shape[0] == 2
        cm = self.confusion_matrix
        return cm[1, 1] / (cm[0, 1] + cm[1, 0] + cm[1, 1])

    def Kappa_coefficient(self) -> float:
        cm = self.confusion_matrix
        n = np.sum(cm)
        observed = np.trace(cm) / n
        expected = np.sum(cm.sum(axis=0) / n * cm.sum(axis=1) / n)
        return (observed - expected) / (1 - expected)

    def Frequency_Weighted_Intersection_over_Union(self) -> float:
        cm = self.confusion_matrix
        freq = cm.sum(axis=1) / cm.sum()
        iu = np.diag(cm) / (cm.sum(axis=1) + cm.sum(axis=0) - np.diag(cm))
        return (freq[freq > 0] * iu[freq > 0]).sum()

    def Class_Weighted_F1_score(self) -> float:
        f1 = self.Damage_F1_score()
        weights = 1 / np.sum(self.confusion_matrix, axis=1)[1:]
        weights = weights / np.sum(weights)
        return np.sum(weights * f1)

    def _generate_matrix(self, gt_image: np.ndarray, pre_image: np.ndarray) -> np.ndarray:
        mask = (gt_image >= 0) & (gt_image < self.num_class)
        label = self.num_class * gt_image[mask].astype("int64") + pre_image[mask]
        count = np.bincount(label, minlength=self.num_class ** 2)
        return count.reshape(self.num_class, self.num_class)

    def add_batch(self, gt_image: np.ndarray, pre_image: np.ndarray) -> None:
        assert gt_image.shape == pre_image.shape
        self.confusion_matrix += self._generate_matrix(gt_image, pre_image)

    def reset(self) -> None:
        self.confusion_matrix = np.zeros((self.num_class,) * 2, dtype=np.longlong)


def parse_predicted_boxes(pred_string: str) -> List[List[float]]:
    """'[x1, y1, x2, y2], ...' -> list of float boxes (silently skipping
    malformed entries, reference detection.py:197-204)."""
    boxes = []
    for box in re.findall(r"\[(.*?)\]", pred_string):
        try:
            boxes.append(list(map(float, box.split(","))))
        except (ValueError, TypeError):
            pass
    return [b for b in boxes if len(b) == 4]


def evaluate_masks(results: Sequence[Dict], dataset: str, height: int = 256,
                   width: int = 256) -> Dict[str, float]:
    """Rasterize GT WKT polygons + predicted [0,100]-normalized boxes into
    binary masks and accumulate the 2-class confusion matrix.

    NB: create_mask receives (height, width) — reproducing the reference
    byte-for-byte (detection.py:185,211 passes (height, width) into PIL's
    width-first Image.new, a transposition quirk that is a no-op at the
    default square 256x256 but part of the paper-number contract)."""
    evaluator = Evaluator(num_class=2)
    for result in results:
        if "[" not in result["ground_truth"]:
            gt_mask = np.zeros((height, width), np.uint8)
        else:
            gt_mask = create_mask(result["polygon"], (height, width))

        if "[" not in result["response"]:
            pred_mask = np.zeros((height, width), np.uint8)
        else:
            boxes = parse_predicted_boxes(result["response"])
            boxes = [
                [b[0] / 100 * width, b[1] / 100 * height,
                 b[2] / 100 * width, b[3] / 100 * height]
                for b in boxes
            ]
            pred_mask = create_mask(boxes_to_wkt(boxes), (height, width))

        evaluator.add_batch(gt_mask, pred_mask)

    return {
        "oa": evaluator.Pixel_Accuracy(),
        "mIoU": evaluator.Mean_Intersection_over_Union(),
        "kappa": evaluator.Kappa_coefficient(),
        "fwIoU": evaluator.Frequency_Weighted_Intersection_over_Union(),
        "precision": evaluator.Pixel_Precision_Rate(),
        "recall": evaluator.Pixel_Recall_Rate(),
        "f1": evaluator.Pixel_F1_score(),
        "IoU": evaluator.Intersection_over_Union(),
    }


def change_detection_classification(
    outputs: Sequence[Dict],
    classes: Sequence[str],
    skip_classes: Sequence[str] = (),
    height: int = 256,
    width: int = 256,
    ignore_casing: bool = True,
    ignore_punctuation: bool = True,
) -> Dict[str, float]:
    """Paint GT polygons with predicted/GT class labels; per-class pixel F1
    aggregated plain / prevalence-weighted / inverse-prevalence-weighted."""
    class_stats = defaultdict(lambda: {"tp": 0, "fp": 0, "fn": 0, "count": 0})
    clean_string = get_string_cleaner(ignore_casing, ignore_punctuation)

    for output in outputs:
        predicted_class = clean_string(output["response"])
        ground_truth_class = clean_string(output["ground_truth"])

        pred_msk = np.zeros((height, width), np.uint8)
        gt_msk = np.zeros((height, width), np.uint8)
        # (height, width) matches the reference's transposition quirk
        # (reference detection.py:236 im_size=(height, width))
        _msk = create_mask(output["polygon"], (height, width))

        if ground_truth_class in skip_classes:
            continue

        if predicted_class not in classes:
            # reference quirk preserved: gt_msk is still all-zero here, so this
            # fn is 0 — out-of-vocab predictions only add to 'count'
            fn = gt_msk.sum()
        else:
            pred_label = classes.index(predicted_class) + 1
            gt_label = classes.index(ground_truth_class) + 1
            pred_msk[_msk > 0] = pred_label
            gt_msk[_msk > 0] = gt_label

            tp = (pred_msk == gt_label).sum()
            fp = (pred_msk == pred_label).sum() - tp
            fn = (gt_msk == gt_label).sum() - tp

            class_stats[predicted_class]["tp"] += tp
            class_stats[predicted_class]["fp"] += fp
        class_stats[ground_truth_class]["fn"] += fn
        class_stats[ground_truth_class]["count"] += np.sum(_msk)

    scores_dict = {}
    total_samples = sum(stats["count"] for stats in class_stats.values())
    prev_weighted = 0.0
    inv_prev_weighted = 0.0
    total_inv_weight = 0.0
    for class_name in classes:
        st = class_stats[class_name]
        tp, fp, fn = st["tp"], st["fp"], st["fn"]
        precision = tp / (tp + fp) if (tp + fp) else 0.0
        recall = tp / (tp + fn) if (tp + fn) else 0.0
        f1 = (
            2 * precision * recall / (precision + recall)
            if (precision + recall)
            else 0.0
        )
        scores_dict[class_name] = f1
        prevalence = st["count"] / total_samples if total_samples else 0.0
        prev_weighted += f1 * prevalence
        if prevalence != 0:
            inv = 1 / prevalence
            inv_prev_weighted += f1 * inv
            total_inv_weight += inv

    inv_prev_weighted = (
        inv_prev_weighted / total_inv_weight if total_inv_weight > 0 else 0.0
    )
    return {
        "f1": float(np.mean(list(scores_dict.values()))),
        "w_f1": float(prev_weighted),
        "inv_w_f1": float(inv_prev_weighted),
    }


XBD_DAMAGE_CLASSES = ["no damage", "minor damage", "major damage", "destroyed"]
QFABRIC_DEV_CLASSES = [
    "residential", "commercial", "industrial", "road", "demolition", "mega projects",
]
QFABRIC_STATUS_CLASSES = [
    "prior construction", "greenland", "land cleared", "excavation",
    "materials dumped", "construction started", "construction midway",
    "construction done", "operational",
]
XBD_QA_KEYWORDS = [
    "yes", "no", "top left", "top center", "top right", "center left", "center",
    "center right", "bottom left", "bottom center", "bottom right",
]


def detection_metrics(
    outputs: Sequence[Dict],
    dataset_name: str,
    ignore_casing: bool = True,
    ignore_punctuation: bool = True,
) -> Dict[str, float]:
    """Per-dataset task dispatch (reference detection.py:301-412)."""
    task2outputs = defaultdict(list)
    for output in outputs:
        task2outputs[output["task"]].append(output)

    kw = dict(ignore_casing=ignore_casing, ignore_punctuation=ignore_punctuation)
    metrics: Dict[str, float] = {}

    for task, outs in task2outputs.items():
        if "xbd" in dataset_name:
            if task == "change_detection_classification":
                assert dataset_name == "xbd_dmg_cls"
                metrics[f"{task}_f1"] = change_detection_classification(
                    outs, XBD_DAMAGE_CLASSES, skip_classes=["unclassified"], **kw
                )["inv_w_f1"]
            elif task == "change_detection_localization":
                metrics[f"{task}_f1"] = evaluate_masks(outs, dataset_name)["f1"]
            elif task == "spatial_referring_expression":
                assert dataset_name == "xbd_sre_qa_rqa"
                metrics[f"{task}_f1"] = evaluate_masks(outs, dataset_name)["f1"]
            elif task == "region_based_question_answering":
                assert dataset_name == "xbd_sre_qa_rqa"
                metrics[f"{task}_accuracy"] = classification_metrics(outs, **kw)[
                    f"{task}_accuracy"
                ]
            elif task == "question_answering":
                assert dataset_name == "xbd_sre_qa_rqa"
                metrics[f"{task}_accuracy"] = classification_metrics(
                    outs, keywords=XBD_QA_KEYWORDS, **kw
                )[f"{task}_accuracy"]
            else:
                raise ValueError(f"Unsupported task {task} for dataset {dataset_name}")

        elif "s2" in dataset_name:
            if task == "change_detection_detection" and dataset_name == "s2_det":
                metrics[f"{task}_f1"] = evaluate_masks(outs, dataset_name)["f1"]
            elif task == "region_based_question_answering":
                assert dataset_name == "s2_rqa"
                metrics[f"{task}_accuracy"] = classification_metrics(outs, **kw)[
                    f"{task}_accuracy"
                ]
            elif task == "spatial_referring_expression":
                assert dataset_name == "s2_sre_qa"
                metrics[f"{task}_f1"] = evaluate_masks(outs, dataset_name)["f1"]
            elif task == "question_answering":
                assert dataset_name == "s2_sre_qa"
                metrics[f"{task}_accuracy"] = classification_metrics(outs, **kw)[
                    f"{task}_accuracy"
                ]
            else:
                raise ValueError(f"Unsupported task {task} for dataset {dataset_name}")

        elif "qfabric" in dataset_name:
            if task == "region_based_question_answering":
                metrics[f"{task}_f1"] = change_detection_classification(
                    outs, QFABRIC_DEV_CLASSES, skip_classes=[], **kw
                )["w_f1"]
            elif task == "region_based_temporal_question_answering":
                if dataset_name == "qfabric_tre_rtqa":
                    metrics[f"{task}_accuracy"] = classification_metrics(outs, **kw)[
                        f"{task}_accuracy"
                    ]
                elif dataset_name == "qfabric_rqa5_rtqa5":
                    metrics[f"{task}_f1"] = change_detection_classification(
                        outs, QFABRIC_STATUS_CLASSES, skip_classes=[], **kw
                    )["w_f1"]
                else:
                    raise ValueError(
                        f"Unsupported dataset {dataset_name} for task {task}"
                    )
            elif task == "temporal_referring_expression":
                assert dataset_name == "qfabric_tre_rtqa"
                metrics[f"{task}_accuracy"] = classification_metrics(outs, **kw)[
                    f"{task}_accuracy"
                ]
            else:
                raise ValueError(f"Unsupported task: {task} for dataset {dataset_name}")
        else:
            raise ValueError(f"Unsupported dataset: {dataset_name}")

    return metrics
