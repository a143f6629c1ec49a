"""AVEC2019 depression-severity loader (the port's copy of
``mimrl_tpu.data.avec``).

Pickle schema (ref: DataLoaderAVEC2019.py): ``avec2019/{train,dev,test}.pkl``
holds a list of per-sample tuples indexed by the ``avec_features`` list
(text, mfcc, ege, ds, au, resnet, label); 'valid' maps to 'dev'
(ref: DataLoaderAVEC2019.py:33-34). With ``--text text`` a sample's text
is its list of sentences, from which the pipeline draws one random word
per sentence and epoch.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from mimrl_tpu_torch.data import registry
from mimrl_tpu_torch.data.pipeline import ArrayDataset, check_split
from mimrl_tpu_torch.data.preprocess import apply_standard_pipeline

avec_features = ["text", "mfcc", "ege", "ds", "au", "resnet", "label"]


def load_avec_dataset(
    mode: str,
    text: str = "text",
    audio: str = "mfcc",
    video: str = "au",
    normalize=(False, False, False),
    log_scale=(False, False, False),
    data_path: str | None = None,
) -> ArrayDataset:
    check_split(mode)
    file_mode = "dev" if mode == "valid" else mode
    data_path = data_path or registry.Data_path_local
    with open(os.path.join(data_path, "avec2019", f"{file_mode}.pkl"), "rb") as f:
        data = pickle.load(f)

    for name in (text, audio, video):
        if name not in avec_features:
            raise ValueError(f"avec2019 has no feature {name!r}")
    mins = registry.dataset_scales_mins["avec2019"]

    raw_l = [d[avec_features.index(text)] for d in data]
    raw_a = [d[avec_features.index(audio)] for d in data]
    raw_v = [d[avec_features.index(video)] for d in data]
    labels = np.asarray([d[-1] for d in data], np.float32).reshape(-1)

    is_text_mode = text == "text"
    if is_text_mode:
        # list of sentences per sample; kept raw — the pipeline samples
        # one random word per sentence per epoch (ref: Customization.py:66-76)
        text_words = [[str(s) for s in np.asarray(l).reshape(-1)] for l in raw_l]
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

    return ArrayDataset(
        text_words=text_words,
        text_feat=l_feats,
        audio=a_feats,
        video=v_feats,
        labels=[labels],
    )
