"""Classification metrics — exact-match accuracy per task.

Math-exact port of reference videollava/eval/classification.py:15-41 (this is
where the fMoW/AID/UCM/ABCD/CDVQA/LRBEN/HRBEN paper numbers come from; the
normalization and keyword-containment rules must not drift).

The port's own copy of teochat_tpu/eval/classification.py.
"""

from __future__ import annotations

import string
from collections import Counter
from typing import Callable, Dict, Optional, Sequence


def get_string_cleaner(ignore_casing: bool, ignore_punctuation: bool) -> Callable[[str], str]:
    def clean_string(s: str) -> str:
        if ignore_casing:
            s = s.lower()
        if ignore_punctuation:
            s = s.translate(str.maketrans("", "", string.punctuation))
        return s

    return clean_string


def classification_metrics(
    outputs: Sequence[Dict],
    ignore_casing: bool = True,
    ignore_punctuation: bool = True,
    keywords: Optional[Sequence[str]] = None,
    **kwargs,
) -> Dict[str, float]:
    """Per-task exact-match accuracy; optional keyword containment match
    (a prediction counts if any keyword appears in BOTH strings)."""
    tps: Counter = Counter()
    task_counts: Counter = Counter()
    clean_string = get_string_cleaner(ignore_casing, ignore_punctuation)
    for output in outputs:
        response = clean_string(output["response"])
        ground_truth = clean_string(output["ground_truth"])
        task = output["task"]
        if keywords is not None:
            matched = False
            for keyword in keywords:
                if keyword in response and keyword in ground_truth:
                    tps[task] += 1
                    matched = True
                    break
            if not matched and response == ground_truth:
                tps[task] += 1
        elif response == ground_truth:
            tps[task] += 1
        task_counts[task] += 1

    return {f"{task}_accuracy": tp / task_counts[task] for task, tp in tps.items()}
