"""Dataset dispatcher: maps a dataset key to (train, valid, test)
BatchPipelines plus per-modality feature dims (the port's counterpart of
``mimrl_tpu.data.universal``; ref: DataLoaderUniversal.py:10-95).
Shuffle only the train split; drop_last applies only to train.

Only the DeclareLab family (``mosi_Dec``, ``mosei_Dec``) is ported; the
SDK, AVEC2019 and local families raise ``NotImplementedError`` until
their ROADMAP.md item lands.
"""

from __future__ import annotations

from typing import Optional, Tuple

from mimrl_tpu_torch.core.config import MimrlConfig
from mimrl_tpu_torch.data import registry
from mimrl_tpu_torch.data.declab import load_dec_dataset
from mimrl_tpu_torch.data.pipeline import BatchPipeline
from mimrl_tpu_torch.data.tokenizer import WordPieceTokenizer, build_tokenizer


def uses_raw_text(opt: MimrlConfig) -> bool:
    """True when the text modality is raw strings tokenized to BERT ids
    (``mimrl_tpu/data/universal.py::uses_raw_text``): the DeclareLab
    family always is, and it is the only family ported."""
    return "Dec" in opt.dataset


def get_data_loader(
    opt: MimrlConfig,
    tokenizer: Optional[WordPieceTokenizer] = None,
) -> Tuple[BatchPipeline, BatchPipeline, BatchPipeline, int, int, int]:
    dataset = opt.dataset
    if dataset not in registry.ALL_DATASETS:
        raise ValueError(f"unknown dataset {dataset!r}")
    if dataset not in ("mosi_Dec", "mosei_Dec"):
        raise NotImplementedError(
            f"dataset {dataset!r}: only the DeclareLab family is ported; "
            "the SDK, AVEC2019 and local loaders are ROADMAP.md item "
            "'Encoders and dataset families'")
    tokenizer = tokenizer or build_tokenizer(opt.bert_vocab)
    kw = dict(batch_size=opt.batch_size, time_len=opt.time_len,
              tokenizer=tokenizer, seed=opt.seed)
    train, valid, test = (load_dec_dataset(dataset, mode, data_path=opt.data_dir)
                          for mode in ("train", "valid", "test"))
    key = "mosi_dec" if "mosi" in dataset else "mosei_dec"
    d_t, d_a, d_v = registry.dataset_dimensions[key]
    return (BatchPipeline(train, shuffle=True, drop_last=opt.drop_last, **kw),
            BatchPipeline(valid, **kw), BatchPipeline(test, **kw),
            d_t, d_a, d_v)
