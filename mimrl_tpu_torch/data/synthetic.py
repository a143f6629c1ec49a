"""Synthetic DeclareLab fixture (the port's copy of
``mimrl_tpu.data.synthetic.make_dec_fixture``): writes tiny pickles in
the Dec schema so the data layer and the serving path run hermetically.
Same seed, same files as the JAX package's generator. Labels carry real
signal (a function of the audio features).
"""

from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np

_WORDS = ("the a very good bad great terrible fine awful nice sad happy movie "
          "film plot actor scene story music end").split()


def _random_words(rng, n_min=3, n_max=12):
    n = rng.integers(n_min, n_max + 1)
    return [str(_WORDS[i]) for i in rng.integers(0, len(_WORDS), n)]


def _signal_label(a_feat: np.ndarray, rng) -> float:
    """Label in [-3, 3] correlated with the audio features."""
    s = float(np.tanh(a_feat.mean()) * 3.0 + rng.normal(0, 0.3))
    return float(np.clip(s, -3.0, 3.0))


def make_dec_fixture(
    root: str,
    dataset: str = "mosi",
    n_per_split: Tuple[int, int, int] = (24, 8, 8),
    d_audio: int = 5,
    d_video: int = 20,
    max_len: int = 12,
    seed: int = 0,
) -> None:
    """DeclareLab schema (ref: DataLoaderCMUDeclareLab.py:143-147).
    Sequence lengths are drawn from [3, max_len)."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    label_cols = 1 if dataset == "mosi" else 7
    for mode, n in zip(("train", "valid", "test"), n_per_split):
        entries = []
        for i in range(n):
            alen = int(rng.integers(3, max_len))
            vlen = int(rng.integers(3, max_len))
            acoustic = rng.normal(size=(alen, d_audio)).astype(np.float32)
            visual = rng.normal(size=(vlen, d_video)).astype(np.float32)
            words = _random_words(rng, 3, max_len)
            label_val = _signal_label(acoustic, rng)
            label = np.full((1, label_cols), label_val, np.float32)
            entries.append((([], visual, acoustic, words, vlen, alen),
                            label, f"vid_{i}"))
        with open(os.path.join(root, f"{dataset}_{mode}.pkl"), "wb") as f:
            pickle.dump(entries, f)
