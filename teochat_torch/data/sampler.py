"""Length/modality-grouped batch sampling (numpy, torch-free).

Behavior port of reference videollava/train/llava_trainer.py:38-130: shuffle,
slice into megabatches of world_size*batch_size, sort each by length, balance
into per-replica chunks, and (optionally) keep multimodal and language-only
samples in separate megabatches so every device batch is modality-homogeneous.
This also stabilizes the bucketed sequence shapes per device batch.
The port's own copy of teochat_tpu/data/sampler.py.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def split_to_even_chunks(indices: Sequence[int], lengths: Sequence[int],
                         num_chunks: int) -> List[List[int]]:
    if len(indices) % num_chunks != 0:
        return [list(indices[i::num_chunks]) for i in range(num_chunks)]
    per_chunk = len(indices) // num_chunks
    chunks: List[List[int]] = [[] for _ in range(num_chunks)]
    chunk_lengths = [0.0] * num_chunks
    for index in indices:
        shortest = chunk_lengths.index(min(chunk_lengths))
        chunks[shortest].append(index)
        chunk_lengths[shortest] += lengths[index]
        if len(chunks[shortest]) == per_chunk:
            chunk_lengths[shortest] = float("inf")
    return chunks


def get_length_grouped_indices(lengths: Sequence[int], batch_size: int,
                               world_size: int, generator=None) -> List[int]:
    rng = generator if generator is not None else np.random.default_rng()
    indices = rng.permutation(len(lengths)).tolist()
    megabatch_size = world_size * batch_size
    megabatches = [
        indices[i : i + megabatch_size] for i in range(0, len(lengths), megabatch_size)
    ]
    megabatches = [
        sorted(m, key=lambda i: lengths[i], reverse=True) for m in megabatches
    ]
    megabatches = [split_to_even_chunks(m, lengths, world_size) for m in megabatches]
    return [i for m in megabatches for chunk in m for i in chunk]


def get_modality_length_grouped_indices(lengths: Sequence[int], batch_size: int,
                                        world_size: int, generator=None) -> List[int]:
    assert all(l != 0 for l in lengths), "Should not have zero length."
    rng = generator if generator is not None else np.random.default_rng()
    if all(l > 0 for l in lengths) or all(l < 0 for l in lengths):
        return get_length_grouped_indices(lengths, batch_size, world_size, generator=rng)
    mm = [(i, l) for i, l in enumerate(lengths) if l > 0]
    lang = [(i, -l) for i, l in enumerate(lengths) if l < 0]
    mm_indices, mm_lengths = zip(*mm)
    lang_indices, lang_lengths = zip(*lang)

    mm_shuffle = [
        mm_indices[i]
        for i in get_length_grouped_indices(mm_lengths, batch_size, world_size, rng)
    ]
    lang_shuffle = [
        lang_indices[i]
        for i in get_length_grouped_indices(lang_lengths, batch_size, world_size, rng)
    ]
    megabatch_size = world_size * batch_size
    mm_mb = [mm_shuffle[i : i + megabatch_size] for i in range(0, len(mm_shuffle), megabatch_size)]
    lang_mb = [lang_shuffle[i : i + megabatch_size] for i in range(0, len(lang_shuffle), megabatch_size)]

    additional = mm_mb[-1] + lang_mb[-1]
    megabatches = mm_mb[:-1] + lang_mb[:-1]
    order = rng.permutation(len(megabatches)).tolist()
    megabatches = [megabatches[i] for i in order]
    if additional:
        megabatches.append(sorted(additional))
    return [i for m in megabatches for i in m]


class LengthGroupedSampler:
    """Iterator over indices; reference llava_trainer.py:99-130."""

    def __init__(self, batch_size: int, world_size: int,
                 lengths: Optional[Sequence[int]] = None, generator=None,
                 group_by_modality: bool = False):
        if lengths is None:
            raise ValueError("Lengths must be provided.")
        self.batch_size = batch_size
        self.world_size = world_size
        self.lengths = lengths
        self.generator = generator
        self.group_by_modality = group_by_modality

    def __len__(self) -> int:
        return len(self.lengths)

    def __iter__(self):
        fn = (
            get_modality_length_grouped_indices
            if self.group_by_modality
            else get_length_grouped_indices
        )
        return iter(fn(self.lengths, self.batch_size, self.world_size, self.generator))
