"""Static-shape batch pipeline (the port's copy of
``mimrl_tpu.data.pipeline``).

Every batch has the same shapes — ``[bs, time_len, d]`` modality arrays,
``[bs, time_len]`` token ids of the raw text (tokenized once, when the
pipeline is built). A partial final batch is cycle-padded with
samples from the epoch start, and ``sample_mask`` marks the real rows
(1) against the padding (0); predictions and metrics keep only the real
rows. Padding is done with numpy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List

import numpy as np

from mimrl_tpu_torch.data.tokenizer import WordPieceTokenizer


@dataclass
class ArrayDataset:
    """Variable-length per-sample features + label arrays."""

    text_words: List[List[str]] = field(default_factory=list)
    audio: List[np.ndarray] = field(default_factory=list)
    video: List[np.ndarray] = field(default_factory=list)
    labels: List[np.ndarray] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.audio)


def _pad_time(x: np.ndarray, time_len: int) -> np.ndarray:
    """Truncate/zero-pad axis 0 to time_len."""
    x = x[:time_len]
    if x.shape[0] < time_len:
        pad = np.zeros((time_len - x.shape[0],) + x.shape[1:], x.dtype)
        x = np.concatenate([x, pad], axis=0)
    return x.astype(np.float32)


def _pad_stack(arrays, time_len: int) -> np.ndarray:
    """[len_i, d] list -> [n, time_len, d]."""
    return np.stack([_pad_time(a, time_len) for a in arrays])


class BatchPipeline:
    """Iterates fixed-shape batches over an ArrayDataset.

    Batch dict fields:
      bert_sentences / bert_sentence_types / bert_sentence_att_mask
          [bs, time_len] int32
      audio [bs, time_len, d_a], video [bs, time_len, d_v]
      labels: list of [bs, ...] arrays
      sample_mask [bs] float32 (1 = real sample)
    """

    def __init__(
        self,
        dataset: ArrayDataset,
        batch_size: int,
        time_len: int,
        tokenizer: WordPieceTokenizer,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
    ):
        self.ds = dataset
        self.bs = batch_size
        self.time_len = time_len
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

        n = len(dataset)
        if n == 0:
            raise ValueError("empty dataset")
        if drop_last and n >= batch_size:
            self.n_batches = n // batch_size
        else:
            self.n_batches = (n + batch_size - 1) // batch_size

        self._audio = _pad_stack(dataset.audio, time_len)
        self._video = _pad_stack(dataset.video, time_len)
        self._tokens = tokenizer.batch_encode(
            [" ".join(w[:time_len]) for w in dataset.text_words], time_len)

    def __len__(self) -> int:
        return self.n_batches

    def epoch_index_plan(self, rng: np.random.Generator):
        """The epoch's batches as ([NB, bs] row ids, [NB, bs] float32
        sample mask): shuffle, then cycle-pad the last batch."""
        order = np.arange(len(self.ds))
        if self.shuffle:
            rng.shuffle(order)
        idx_rows, mask_rows = [], []
        for b in range(self.n_batches):
            idx = order[b * self.bs:(b + 1) * self.bs]
            mask = np.ones(len(idx), np.float32)
            if len(idx) < self.bs:
                # cycle-pad with epoch-start samples, masked out
                extra = order[: self.bs - len(idx)]
                idx = np.concatenate([idx, extra])
                mask = np.concatenate(
                    [mask, np.zeros(self.bs - len(mask), np.float32)])
            idx_rows.append(idx)
            mask_rows.append(mask)
        return np.stack(idx_rows), np.stack(mask_rows)

    def __iter__(self) -> Iterator[Dict]:
        rng = np.random.default_rng(self.seed + self._epoch)
        idx_plan, mask_plan = self.epoch_index_plan(rng)
        self._epoch += 1

        ids, types, amask = self._tokens
        for idx, mask in zip(idx_plan, mask_plan):
            yield {
                "bert_sentences": ids[idx],
                "bert_sentence_types": types[idx],
                "bert_sentence_att_mask": amask[idx],
                "audio": self._audio[idx],
                "video": self._video[idx],
                "labels": [np.asarray(lab)[idx] for lab in self.ds.labels],
                "sample_mask": mask,
            }
