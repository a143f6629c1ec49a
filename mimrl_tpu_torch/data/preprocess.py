"""Host-side feature preprocessing shared by the feature loaders (the
port's copy of ``mimrl_tpu.data.preprocess``): NaN scrub, log-scaling
against the registry's frozen minima, and split-wide min-max
normalisation to [-1, 1] (ref: DataLoaderCMUSDK.py:93-112,
DataLoaderAVEC2019.py:41-61).
"""

from __future__ import annotations

from typing import List

import numpy as np


def nan_scrub(features: List[np.ndarray]) -> List[np.ndarray]:
    return [np.nan_to_num(f, nan=0.0, posinf=0, neginf=0) for f in features]


def log_scale(features: List[np.ndarray], scale_min: float) -> List[np.ndarray]:
    """f -> log(f - min + 1 + 1e-6), NaN-scrubbed after
    (ref: DataLoaderCMUSDK.py:97-102)."""
    return [np.nan_to_num(np.log(f - scale_min + 1 + 1e-6)) for f in features]


def minmax_normalize(features: List[np.ndarray]) -> List[np.ndarray]:
    """Global (split-wide) min-max to [-1, 1]
    (ref: DataLoaderCMUSDK.py:104-112)."""
    max_v = max(np.max(f) for f in features)
    min_v = min(np.min(f) for f in features)
    denom = max_v - min_v
    if denom == 0:
        denom = 1.0
    return [2 * (f - min_v) / denom - 1 for f in features]


def apply_standard_pipeline(features: List[np.ndarray], do_log: bool,
                            scale_min, do_normalize: bool) -> List[np.ndarray]:
    features = nan_scrub(features)
    if do_log:
        features = log_scale(features, scale_min)
    if do_normalize:
        features = minmax_normalize(features)
    return [np.asarray(f, np.float32) for f in features]
