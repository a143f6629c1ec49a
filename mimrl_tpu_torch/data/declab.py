"""DeclareLab ("Dec") CMU-MOSI/MOSEI loader (the port's copy of
``mimrl_tpu.data.declab.load_dec_dataset``).

Pickle schema (ref: DataLoaderCMUDeclareLab.py:143-147): each of
``mosi_{train,valid,test}.pkl`` / ``mosei_*`` holds a list of
``((words, visual, acoustic, actual_words, vlen, alen), label, id)``.
MOSEI's 7-column sentiment matrix collapses to its first column
(ref: DataLoaderCMUDeclareLab.py:388-389).

``build_from_noalign`` rebuilds those pickles from the raw CMU
distribution's ``*_data_noalign.pkl`` and label CSV, as JAX's does, with
the stdlib ``csv`` reader in place of pandas.
"""

from __future__ import annotations

import csv
import os
import pickle
import re
from typing import List

import numpy as np

from mimrl_tpu_torch.data import registry
from mimrl_tpu_torch.data.pipeline import ArrayDataset, check_split


def load_dec_dataset(dataset: str, mode: str,
                     data_path: str | None = None) -> ArrayDataset:
    check_split(mode)
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


def _csv_cell(value: str):
    """A CSV cell as pandas' ``read_csv`` gives an integer column's
    value: an int where the text is one, else the string."""
    try:
        return int(value)
    except ValueError:
        return value


def build_from_noalign(data_path: str, name: str = "mosi") -> None:
    """Write ``{name}_{split}.pkl`` from ``{name}_data_noalign.pkl`` and
    ``{NAME}-label.csv`` (ref: DataLoaderCMUDeclareLab.py:35-165), the
    same bytes as the JAX package's ``build_from_noalign``."""
    pickle_filename = os.path.join(data_path, f"{name}_data_noalign.pkl")
    csv_filename = os.path.join(data_path, f"{name.upper()}-label.csv")
    with open(pickle_filename, "rb") as f:
        d = pickle.load(f)
    with open(csv_filename, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    text = [r["text"] for r in rows]
    all_csv_id = [(r["video_id"], str(_csv_cell(r["clip_id"]))) for r in rows]

    def get_length(x):
        return x.shape[1] - (np.sum(x, axis=-1) == 0).sum(1)

    splits = [d["train"], d["valid"], d["test"]]
    v = np.concatenate([s["vision"] for s in splits], axis=0)
    a = np.concatenate([s["audio"] for s in splits], axis=0)
    label = np.concatenate([s["labels"] for s in splits], axis=0)
    vlens, alens = get_length(v), get_length(a)
    L_V, L_A = v.shape[1], a.shape[1]
    all_id = np.concatenate([s["id"] for s in splits], axis=0)[:, 0]
    all_id_list = [x.decode("utf-8") for x in all_id.tolist()]
    sizes = [len(s["id"]) for s in splits]
    dev_start, test_start = sizes[0], sizes[0] + sizes[1]
    pattern = re.compile("(.*)_(.*)")

    out = {"train": [], "valid": [], "test": []}
    for i, idd in enumerate(all_id_list):
        idd1, idd2 = re.search(pattern, idd).group(1, 2)
        index = all_csv_id.index((idd1, idd2))
        entry = (
            ([], np.nan_to_num(v[i][L_V - vlens[i]:, :]),
             np.nan_to_num(a[i][L_A - alens[i]:, :]), text[index].split(),
             vlens[i], alens[i]),
            label[i].astype(np.float32),
            idd,
        )
        split = ("train" if i < dev_start
                 else "valid" if i < test_start else "test")
        out[split].append(entry)

    for split, entries in out.items():
        with open(os.path.join(data_path, f"{name}_{split}.pkl"), "wb") as f:
            pickle.dump(entries, f)
