"""A seeded DeclareLab split set: the pickles that MIMRL's DeclareLab loader
reads (``DataLoaderCMUDeclareLab.py:143-147``), at a configuration's fold
sizes and feature widths.

Each utterance has audio and video rows of lengths drawn uniformly from
``[3, max_len)``, normal features, 3 to ``max_len`` words drawn from a
vocabulary of ``n_words`` synthetic words, and a label in [-3, 3] that
follows the audio (``tanh(mean) * 3`` plus noise), as MIMRL's synthetic
fixtures make them. MOSEI's label is its 7-column sentiment row. The same
seed gives the same utterances.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List

import numpy as np

SPLITS = ("train", "valid", "test")


def utterances(dataset: Dict, seed: int) -> Dict[str, List]:
    """{split: [(audio, video, words, label)]} for a configuration's
    ``dataset`` section."""
    rng = np.random.default_rng(seed)
    d_a, d_v = dataset["d_audio"], dataset["d_video"]
    max_len, n_words = dataset["max_len"], dataset["n_words"]
    out = {}
    for split, n in zip(SPLITS, dataset["splits"]):
        alen = rng.integers(3, max_len, n)
        vlen = rng.integers(3, max_len, n)
        nw = rng.integers(3, max_len + 1, n)
        audio = rng.standard_normal((int(alen.sum()), d_a), np.float32)
        video = rng.standard_normal((int(vlen.sum()), d_v), np.float32)
        words = rng.integers(0, n_words, int(nw.sum()))
        noise = rng.normal(0.0, 0.3, n)
        a_at = np.concatenate([[0], np.cumsum(alen)])
        v_at = np.concatenate([[0], np.cumsum(vlen)])
        w_at = np.concatenate([[0], np.cumsum(nw)])
        rows = []
        for i in range(n):
            a = audio[a_at[i]:a_at[i + 1]]
            label = float(np.clip(np.tanh(a.mean()) * 3.0 + noise[i], -3, 3))
            rows.append((a, video[v_at[i]:v_at[i + 1]],
                         [f"w{j}" for j in words[w_at[i]:w_at[i + 1]]],
                         label))
        out[split] = rows
    return out


def write(root: str, dataset: Dict, utts: Dict[str, List]) -> None:
    """``{name}_{split}.pkl`` under ``root``, in DeclareLab's layout."""
    os.makedirs(root, exist_ok=True)
    cols = 1 if dataset["name"] == "mosi" else 7
    for split, rows in utts.items():
        entries = [(([], v, a, w, len(v), len(a)),
                    np.full((1, cols), y, np.float32), f"vid_{i}")
                   for i, (a, v, w, y) in enumerate(rows)]
        with open(os.path.join(root, f"{dataset['name']}_{split}.pkl"),
                  "wb") as f:
            pickle.dump(entries, f, protocol=pickle.HIGHEST_PROTOCOL)
