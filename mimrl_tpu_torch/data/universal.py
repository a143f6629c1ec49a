"""Dataset dispatcher: maps a dataset key to (train, valid, test)
BatchPipelines plus per-modality feature dims (the port's counterpart of
``mimrl_tpu.data.universal``; ref: DataLoaderUniversal.py:10-95) for
the four families: CMU-SDK (``mosi_SDK``, ``mosei_SDK``, ``pom_SDK``),
DeclareLab (``mosi_Dec``, ``mosei_Dec``), AVEC2019 and the local dense
datasets. Shuffle only the train split; drop_last applies only to train.
``get_dataset_scales`` and ``test_all_dataset`` are the maintenance
helpers of JAX's module (ref: DataLoaderUniversal.py:98-152).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from mimrl_tpu_torch.core.config import MimrlConfig
from mimrl_tpu_torch.data import registry
from mimrl_tpu_torch.data.avec import load_avec_dataset
from mimrl_tpu_torch.data.declab import load_dec_dataset
from mimrl_tpu_torch.data.local import LOCAL_DATASETS, load_local_dataset
from mimrl_tpu_torch.data.pipeline import SPLITS, BatchPipeline
from mimrl_tpu_torch.data.sdk import load_sdk_dataset
from mimrl_tpu_torch.data.tokenizer import WordPieceTokenizer, build_tokenizer


def uses_raw_text(opt: MimrlConfig) -> bool:
    """True when the text modality is raw words tokenised to BERT ids;
    False when it is dense pre-extracted features with no BERT. The
    DeclareLab family is always raw, the local family always dense, and
    SDK and AVEC follow ``--text``."""
    if "Dec" in opt.dataset:
        return True
    if opt.dataset in LOCAL_DATASETS:
        return False
    return opt.text == "text"


def get_data_loader(
    opt: MimrlConfig,
    tokenizer: Optional[WordPieceTokenizer] = None,
) -> Tuple[BatchPipeline, BatchPipeline, BatchPipeline, int, int, int]:
    dataset = opt.dataset
    if dataset not in registry.ALL_DATASETS:
        raise ValueError(f"unknown dataset {dataset!r}")
    norm, logs, root = opt.normalize, opt.log_scale, opt.data_dir
    if "SDK" in dataset:
        splits = [load_sdk_dataset(dataset.split("_")[0], mode, text=opt.text,
                                   audio=opt.audio, video=opt.video,
                                   normalize=norm, log_scale=logs,
                                   data_path=root) for mode in SPLITS]
    elif "Dec" in dataset:
        splits = [load_dec_dataset(dataset, mode, data_path=root)
                  for mode in SPLITS]
    elif dataset == "avec2019":
        splits = [load_avec_dataset(mode, text=opt.text, audio=opt.audio,
                                    video=opt.video, normalize=norm,
                                    log_scale=logs, data_path=root)
                  for mode in SPLITS]
    else:
        splits = [load_local_dataset(dataset, mode, normalize=norm,
                                     log_scale=logs, data_path=root)
                  for mode in SPLITS]

    if "SDK" in dataset or dataset == "avec2019":
        dims = registry.dataset_dimensions[dataset]
        d_t, d_a, d_v = dims[0][opt.text], dims[1][opt.audio], dims[2][opt.video]
    elif "Dec" in dataset:
        d_t, d_a, d_v = registry.dataset_dimensions[
            "mosi_dec" if "mosi" in dataset else "mosei_dec"]
    else:
        d_t, d_a, d_v = registry.dataset_dimensions[dataset]

    raw = uses_raw_text(opt)
    kw = dict(batch_size=opt.batch_size, time_len=opt.time_len,
              tokenizer=(tokenizer or build_tokenizer(opt.bert_vocab)
                         if raw else None),
              seed=opt.seed,
              avec_random_word=dataset == "avec2019" and raw)
    train, valid, test = splits
    return (BatchPipeline(train, shuffle=True, drop_last=opt.drop_last, **kw),
            BatchPipeline(valid, **kw), BatchPipeline(test, **kw),
            d_t, d_a, d_v)


def get_label_from_datas(opt: MimrlConfig, batch: Dict) -> np.ndarray:
    """A batch's target for the run's dataset and task (ref:
    Solver.py:272-315, ``mimrl_tpu/train/solver.py:251-276``): the SDK
    and mosi/mosei local families hold (regression, 2-class, 7-class)
    labels; POM's first label array has 18 columns, of which ``pom_SDK``
    trains on column 0 and the local ``pom`` on column -3."""
    labels = batch["labels"]
    dataset, task, num_class = opt.dataset, opt.task, opt.num_class
    if dataset in ("mosi_Dec", "mosei_Dec", "avec2019", "youtube",
                   "youtubev2", "moud", "iemocap_20"):
        return labels[0]
    if dataset in ("mosi_SDK", "mosei_SDK", "mosi_20", "mosi_50",
                   "mosei_20", "mosei_50"):
        if task == "regression":
            return labels[0]
        if num_class in (2, 7):
            return labels[1 if num_class == 2 else 2]
        raise NotImplementedError(
            f"{dataset}: classification into {num_class} classes")
    if dataset in ("pom_SDK", "pom"):
        if task != "regression":
            return labels[1]
        return labels[0][:, 0 if dataset == "pom_SDK" else -3]
    if dataset in ("mmmo", "mmmov2"):
        return labels[0] if task == "regression" else labels[1]
    raise NotImplementedError(dataset)


def get_dataset_scales(datasets=None, **cfg_overrides):
    """Per-modality min/max over every split of each dataset, the scan
    that produced the frozen tables in ``registry`` (ref:
    DataLoaderUniversal.py:98-126). Returns {name: (mins, maxs)}."""
    datasets = datasets or registry.ALL_DATASETS
    results = {}
    for name in datasets:
        kw = dict(dataset=name, text="glove", audio="covarep",
                  video="facet42", time_len=200, normalize=[False] * 3,
                  log_scale=[False] * 3, batch_size=1024, num_workers=0)
        kw.update(cfg_overrides)
        mins = [np.inf] * 3
        maxs = [-np.inf] * 3
        for loader in get_data_loader(MimrlConfig(**kw))[:3]:
            for batch in loader:
                mods = [batch.get("text"), batch["audio"], batch["video"]]
                for i, m in enumerate(mods):
                    if m is None:
                        continue
                    mins[i] = min(mins[i], float(m.min()))
                    maxs[i] = max(maxs[i], float(m.max()))
        results[name] = (mins, maxs)
    return results


def test_all_dataset(datasets=None, **cfg_overrides):
    """Iterate one batch of every dataset's train split and check the
    feature widths against the registry (ref: DataLoaderUniversal.py:
    139-152); raises ``ValueError`` naming the dataset on a mismatch."""
    datasets = datasets or registry.ALL_DATASETS
    for name in datasets:
        is_avec = name == "avec2019"
        kw = dict(
            dataset=name, text="glove",
            audio="covarep" if not is_avec else "ds",
            video="facet42" if not is_avec else "resnet",
            normalize=[False, True, True], log_scale=[False, True, True],
            time_len=100, batch_size=1024, num_workers=0)
        kw.update(cfg_overrides)
        train, _, _, _d_t, d_a, d_v = get_data_loader(MimrlConfig(**kw))
        for batch in train:
            for key, want in (("audio", d_a), ("video", d_v)):
                if batch[key].shape[-1] != want:
                    raise ValueError(f"{name}: {key} width "
                                     f"{batch[key].shape[-1]}, registry {want}")
            break
