"""Synthetic dataset fixtures (the port's copy of
``mimrl_tpu.data.synthetic``): tiny pickles in every on-disk schema the
loaders read (CMU-SDK, DeclareLab, AVEC2019, local), so the data layer
and end-to-end training run hermetically. The same seed writes the same
files as the JAX package's generators. Feature dims default to the
registry's real dims but can be shrunk for speed; the labels carry real
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


def make_sdk_fixture(
    root: str,
    dataset: str = "mosi",
    n_per_split: Tuple[int, int, int] = (24, 8, 8),
    d_text: int = 300,
    d_audio: int = 74,
    d_video: int = 35,
    max_len: int = 12,
    seed: int = 0,
) -> None:
    """CMU-SDK schema (ref: DataLoaderCMUSDK.py:12-28, :86-119).

    Feature-list layout: text list has 6 slots (text/glove/...), audio 3
    (mosi) or 1, video 3 (mosi) or 1; unused slots get tiny arrays.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    n_l, n_a, n_v = (6, 3, 3) if dataset == "mosi" else (6, 1, 1)
    for mode, n in zip(("train", "valid", "test"), n_per_split):
        entries = []
        for _ in range(n):
            L = int(rng.integers(3, max_len))
            words = np.asarray(_random_words(rng, 3, max_len), dtype=object)
            glove = rng.normal(size=(L, d_text)).astype(np.float32)
            l_feats = [None] * n_l
            l_feats[0] = words  # 'text'
            for i in range(1, n_l):
                l_feats[i] = glove
            a = rng.normal(size=(L, d_audio)).astype(np.float32)
            a_feats = [a] * n_a
            v = rng.normal(size=(L, d_video)).astype(np.float32)
            v_feats = [v] * n_v
            label = _signal_label(a, rng)
            label_2 = int(label > 0)
            if dataset == "pom":
                label18 = rng.uniform(1, 7, size=(18,)).astype(np.float32)
                label_7 = int(np.clip(np.round(label18[0]), 1, 7))
                entries.append([[l_feats, a_feats, v_feats], label18, label_7,
                                f"seg{_}"])
            else:
                label_7 = int(np.clip(np.round(label), -3, 3)) + 3
                entries.append([[l_feats, a_feats, v_feats], label, label_2,
                                label_7, f"seg{_}"])
        with open(os.path.join(root, f"{dataset}_{mode}.pkl"), "wb") as f:
            pickle.dump(entries, f)


def make_dec_fixture(
    root: str,
    dataset: str = "mosi",
    n_per_split: Tuple[int, int, int] = (24, 8, 8),
    d_audio: int = 5,
    d_video: int = 20,
    max_len: int = 12,
    seed: int = 0,
) -> None:
    """DeclareLab schema (ref: DataLoaderCMUDeclareLab.py:143-147)."""
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


def make_avec_fixture(
    root: str,
    n_per_split: Tuple[int, int, int] = (16, 6, 6),
    d_mfcc: int = 39,
    d_au: int = 49,
    max_len: int = 10,
    seed: int = 0,
) -> None:
    """AVEC2019 schema (ref: DataLoaderAVEC2019.py:13, :32-44):
    per-sample tuple (text, mfcc, ege, ds, au, resnet, label)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "avec2019"), exist_ok=True)
    for mode, n in zip(("train", "dev", "test"), n_per_split):
        entries = []
        for _ in range(n):
            L = int(rng.integers(3, max_len))
            sentences = np.asarray(
                [" ".join(_random_words(rng, 2, 6)) for _ in range(L)],
                dtype=object)
            mfcc = rng.normal(size=(L, d_mfcc)).astype(np.float32)
            ege = rng.normal(size=(L, 23)).astype(np.float32)
            ds = rng.normal(size=(L, 8)).astype(np.float32)
            au = rng.normal(size=(L, d_au)).astype(np.float32)
            resnet = rng.normal(size=(L, 16)).astype(np.float32)
            label = float(np.clip(abs(mfcc.mean()) * 10, 0, 24))
            entries.append((sentences, mfcc, ege, ds, au, resnet, label))
        with open(os.path.join(root, "avec2019", f"{mode}.pkl"), "wb") as f:
            pickle.dump(entries, f)


def make_local_fixture(
    root: str,
    dataset: str = "mosi_20",
    n_per_split: Tuple[int, int, int] = (16, 6, 6),
    dims: Tuple[int, int, int] = (300, 5, 20),
    time_len: int = 20,
    seed: int = 0,
) -> None:
    """The local schema (``data/local.py``; the reference's loader is
    missing from its repository)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, dataset), exist_ok=True)
    d_t, d_a, d_v = dims
    for mode, n in zip(("train", "valid", "test"), n_per_split):
        t = [rng.normal(size=(time_len, d_t)).astype(np.float32)
             for _ in range(n)]
        a = [rng.normal(size=(time_len, d_a)).astype(np.float32)
             for _ in range(n)]
        v = [rng.normal(size=(time_len, d_v)).astype(np.float32)
             for _ in range(n)]
        reg = np.asarray([_signal_label(x, rng) for x in a], np.float32)
        lab2 = (reg > 0).astype(np.int64)
        lab7 = (np.clip(np.round(reg), -3, 3) + 3).astype(np.int64)
        if dataset == "pom":
            reg = np.stack([np.clip(reg + 4, 1, 7)] * 18, axis=1)
        data = {"text": t, "audio": a, "video": v,
                "labels": [reg, lab2, lab7]}
        with open(os.path.join(root, dataset, f"{mode}.pkl"), "wb") as f:
            pickle.dump(data, f)
