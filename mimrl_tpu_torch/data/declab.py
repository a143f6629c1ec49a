"""DeclareLab ("Dec") CMU-MOSI/MOSEI loader (the port's copy of
``mimrl_tpu.data.declab.load_dec_dataset``).

Pickle schema (ref: DataLoaderCMUDeclareLab.py:143-147): each of
``mosi_{train,valid,test}.pkl`` / ``mosei_*`` holds a list of
``((words, visual, acoustic, actual_words, vlen, alen), label, id)``.
MOSEI's 7-column sentiment matrix collapses to its first column
(ref: DataLoaderCMUDeclareLab.py:388-389).

``build_from_noalign`` of the JAX package is not carried over: it needs
pandas.
"""

from __future__ import annotations

import os
import pickle
from typing import List

import numpy as np

from mimrl_tpu_torch.data import registry
from mimrl_tpu_torch.data.pipeline import ArrayDataset


def load_dec_dataset(dataset: str, mode: str,
                     data_path: str | None = None) -> ArrayDataset:
    if mode not in ("train", "valid", "test"):
        raise ValueError(f"unknown split {mode!r}")
    name = "mosi" if "mosi" in dataset else "mosei"
    data_path = data_path or registry.Data_path_DecLab
    with open(os.path.join(data_path, f"{name}_{mode}.pkl"), "rb") as f:
        data = pickle.load(f)

    text_words: List[List[str]] = []
    audio: List[np.ndarray] = []
    video: List[np.ndarray] = []
    labels: List[np.ndarray] = []
    for (_words, visual, acoustic, actual_words, _vlen, _alen), label, _id in data:
        text_words.append([str(w) for w in actual_words])
        audio.append(np.nan_to_num(np.asarray(acoustic, np.float32)))
        video.append(np.nan_to_num(np.asarray(visual, np.float32)))
        lab = np.asarray(label, np.float32).reshape(-1)
        if lab.shape[0] == 7:  # MOSEI sentiment matrix -> first column
            lab = lab[:1]
        labels.append(lab)

    label_arr = np.asarray(labels, np.float32).reshape(len(labels), -1)
    return ArrayDataset(text_words=text_words, audio=audio, video=video,
                        labels=[label_arr])
