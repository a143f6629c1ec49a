"""'Local' dense datasets (mosi_20/50, mosei_20/50, youtube(v2),
mmmo(v2), moud, pom, iemocap_20): the port's copy of
``mimrl_tpu.data.local``, whose regression-to-class bucketers are
``eval/metrics.py``'s.

The reference imports ``DataLoaderLocal`` (ref: Solver.py:12) but the file
is absent from its repository; the JAX package reconstructed it from the
call sites, and owns its on-disk schema: ``<root>/<dataset>/<mode>.pkl``
holding ``{'text': [n arrays], 'audio': [...], 'video': [...],
'labels': [arr, ...]}``. Text is always dense (glove-like features).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from mimrl_tpu_torch.data import registry
from mimrl_tpu_torch.data.pipeline import ArrayDataset, check_split
from mimrl_tpu_torch.data.preprocess import apply_standard_pipeline

LOCAL_DATASETS = [
    "mosi_20", "mosi_50", "mosei_20", "mosei_50", "youtube", "youtubev2",
    "mmmo", "mmmov2", "moud", "pom", "iemocap_20",
]


def load_local_dataset(
    dataset: str,
    mode: str,
    normalize=(False, False, False),
    log_scale=(False, False, False),
    data_path: str | None = None,
) -> ArrayDataset:
    if dataset not in LOCAL_DATASETS:
        raise ValueError(f"unknown local dataset {dataset!r}")
    check_split(mode)
    data_path = data_path or registry.Data_path_local
    with open(os.path.join(data_path, dataset, f"{mode}.pkl"), "rb") as f:
        data = pickle.load(f)

    mins = registry.dataset_scales_mins[dataset]
    t = apply_standard_pipeline(
        [np.asarray(x) for x in data["text"]], log_scale[0],
        mins[0] if log_scale[0] else None, normalize[0])
    a = apply_standard_pipeline(
        [np.asarray(x) for x in data["audio"]], log_scale[1],
        mins[1] if log_scale[1] else None, normalize[1])
    v = apply_standard_pipeline(
        [np.asarray(x) for x in data["video"]], log_scale[2],
        mins[2] if log_scale[2] else None, normalize[2])

    labels = [np.asarray(lab) for lab in data["labels"]]
    return ArrayDataset(text_feat=t, audio=a, video=v, labels=labels)
