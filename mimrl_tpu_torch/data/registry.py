"""Static dataset registry: root paths and per-modality feature dimensions
(the port's copy of ``mimrl_tpu.data.registry``; values reproduce the
reference's frozen tables, ref: Config.py:57-89).

The per-dataset log-scale min/max tables are not copied yet: the Dec
family, the only one the port loads so far, applies no scaling.
"""

from __future__ import annotations

import os

Data_path_DecLab = os.environ.get(
    "MIMRL_DATA_DECLAB", "/newdata/sh/MMDatasets/CMU_DeclareLab_Dataset"
)

# Per-modality feature dims per dataset key (ref: Config.py:57-89)
dataset_dimensions = {
    "mosi_SDK": [
        {"glove": 300, "last_hidden_state": 768, "masked_last_hidden_state": 768,
         "summed_last_four_states": 768, "text": 768},
        {"covarep": 74, "opensmile_eb10": 1585, "opensmile_is09": 384},
        {"facet41": 47, "facet42": 35, "openface": 430},
    ],
    "mosei_SDK": [
        {"glove": 300, "last_hidden_state": 768, "masked_last_hidden_state": 768,
         "summed_last_four_states": 768, "text": 768},
        {"covarep": 74},
        {"facet42": 35},
    ],
    "pom_SDK": [
        {"glove": 300, "last_hidden_state": 768, "masked_last_hidden_state": 768,
         "summed_last_four_states": 768, "text": 768},
        {"covarep": 43},
        {"facet42": 35},
    ],
    "avec2019": [
        {"text": 768},
        {"mfcc": 39, "ege": 23, "ds": 1920},
        {"au": 49, "resnet": 2048},
    ],
    "mosi_dec": [768, 5, 20],
    "mosei_dec": [768, 74, 35],
    "mosi_20": [300, 5, 20],
    "mosi_50": [300, 5, 20],
    "mosei_20": [300, 74, 35],
    "mosei_50": [300, 74, 35],
    "youtube": [300, 74, 36],
    "youtubev2": [300, 74, 35],
    "mmmo": [300, 74, 36],
    "mmmov2": [300, 74, 35],
    "moud": [300, 74, 35],
    "pom": [300, 43, 43],
    "iemocap_20": [300, 74, 35],
}

ALL_DATASETS = [
    "mosi_SDK", "mosei_SDK", "pom_SDK", "mosi_20", "mosi_50", "youtube",
    "youtubev2", "mmmo", "mmmov2", "moud", "pom", "iemocap_20", "mosei_20",
    "mosei_50", "avec2019", "mosi_Dec", "mosei_Dec",
]
