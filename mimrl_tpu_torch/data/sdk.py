"""CMU-SDK pickle loaders for MOSI, MOSEI and POM (the port's copy of
``mimrl_tpu.data.sdk``).

Pickle schema (ref: DataLoaderCMUSDK.py): each file
``{mosi,mosei,pom}_{train,valid,test}.pkl`` is a list of
``[[l_feats, a_feats, v_feats], label, (label_2,) label_7, segment]``
entries where each ``*_feats`` is a list of per-featureset arrays indexed
by the canonical feature-name lists below. ``--text text`` keeps the
words (tokenised for BERT); any other text feature is dense. The
regression-to-class bucketers are ``eval/metrics.py``'s.
"""

from __future__ import annotations

import os
import pickle
from typing import List

import numpy as np

from mimrl_tpu_torch.data import registry
from mimrl_tpu_torch.data.pipeline import ArrayDataset, check_split
from mimrl_tpu_torch.data.preprocess import apply_standard_pipeline
from mimrl_tpu_torch.eval.metrics import mosi_r2c_7

# (ref: DataLoaderCMUSDK.py:13-28)
mosi_l_features = ["text", "glove", "last_hidden_state",
                   "masked_last_hidden_state", "pooler_output",
                   "summed_last_four_states"]
mosi_a_features = ["covarep", "opensmile_eb10", "opensmile_is09"]
mosi_v_features = ["facet41", "facet42", "openface"]
mosei_l_features = mosi_l_features
mosei_a_features = ["covarep"]
mosei_v_features = ["facet42"]
pom_l_features = mosi_l_features
pom_a_features = ["covarep"]
pom_v_features = ["facet42"]

_FEATURE_LISTS = {
    "mosi": (mosi_l_features, mosi_a_features, mosi_v_features),
    "mosei": (mosei_l_features, mosei_a_features, mosei_v_features),
    "pom": (pom_l_features, pom_a_features, pom_v_features),
}


def _load_split(dataset: str, mode: str, data_path: str):
    path = os.path.join(data_path, f"{dataset}_{mode}.pkl")
    with open(path, "rb") as f:
        return pickle.load(f)


def load_sdk_dataset(
    dataset: str,
    mode: str,
    text: str = "glove",
    audio: str = "covarep",
    video: str = "facet42",
    normalize=(True, True, True),
    log_scale=(False, False, False),
    data_path: str | None = None,
) -> ArrayDataset:
    """Build an ArrayDataset from a CMU-SDK pickle
    (ref: DataLoaderCMUSDK.py:86-186)."""
    if dataset not in _FEATURE_LISTS:
        raise ValueError(f"unknown CMU-SDK dataset {dataset!r}")
    check_split(mode)
    data_path = data_path or registry.Data_path_SDK
    l_list, a_list, v_list = _FEATURE_LISTS[dataset]
    for kind, name, names in (("text", text, l_list), ("audio", audio, a_list),
                              ("video", video, v_list)):
        if name not in names:
            raise ValueError(f"{dataset} has no {kind} feature {name!r}")

    data = _load_split(dataset, mode, data_path)
    scales_key = f"{dataset}_SDK"
    mins = registry.dataset_scales_mins[scales_key]

    raw_l = [d[0][0][l_list.index(text)] for d in data]
    raw_a = [d[0][1][a_list.index(audio)] for d in data]
    raw_v = [d[0][2][v_list.index(video)] for d in data]

    is_text_mode = text == "text"
    if is_text_mode:
        # raw word arrays; no numeric preprocessing
        text_words = [[str(w) for w in np.asarray(l).reshape(-1)] for l in raw_l]
        l_feats = None
    else:
        text_words = None
        l_feats = apply_standard_pipeline(
            raw_l, log_scale[0],
            mins[0].get(text) if log_scale[0] else None, normalize[0])

    a_feats = apply_standard_pipeline(
        raw_a, log_scale[1], mins[1].get(audio) if log_scale[1] else None,
        normalize[1])
    v_feats = apply_standard_pipeline(
        raw_v, log_scale[2], mins[2].get(video) if log_scale[2] else None,
        normalize[2])

    if dataset == "pom":
        labels = np.asarray([np.asarray(d[1], np.float32).reshape(-1)
                             for d in data])  # [n, 18]
        labels_7 = np.asarray([d[2] for d in data]).reshape(-1).astype(np.int64)
        label_list = [labels, labels_7]
    else:
        labels = np.asarray([d[1] for d in data]).reshape(-1).astype(np.float32)
        labels_2 = np.asarray([d[2] for d in data]).reshape(-1).astype(np.int64)
        if dataset == "mosi":
            # modified regression->7-class rule (ref: DataLoaderCMUSDK.py:117)
            labels_7 = np.asarray([mosi_r2c_7(d[1]) for d in data]).reshape(-1)
        else:
            labels_7 = np.asarray([d[3] for d in data]).reshape(-1).astype(np.int64)
        label_list = [labels, labels_2, labels_7]

    return ArrayDataset(
        text_words=text_words,
        text_feat=l_feats,
        audio=a_feats,
        video=v_feats,
        labels=label_list,
    )
