"""Batches of a DeclareLab split as the reference sees them, from the raw
utterances the benchmark generated: the words framed as BERT's
``[CLS] ... [SEP]`` with hash-bucket ids over the vocabulary, the feature
rows truncated or zero-padded to ``time_len``, and the epoch's order (a
shuffle by ``numpy.random.default_rng(seed + pass)`` for the train split,
dataset order otherwise) with the last batch cycle-padded from the epoch's
first rows and masked out.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence

import numpy as np
import torch

PAD, CLS, SEP, N_SPECIAL = 0, 2, 3, 5


def word_id(word: str, vocab: int) -> int:
    h = int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")
    return N_SPECIAL + h % (vocab - N_SPECIAL)


def encode(words: Sequence[str], T: int, vocab: int):
    """(ids, types, mask), each [T] int32."""
    body = [word_id(w.lower(), vocab) for w in words[:T]][:T - 2]
    ids = [CLS] + body + [SEP]
    ids = np.asarray(ids + [PAD] * (T - len(ids)), np.int32)
    mask = (np.arange(T) < len(body) + 2).astype(np.int32)
    return ids, np.zeros(T, np.int32), mask


def pad(rows: np.ndarray, T: int) -> np.ndarray:
    out = np.zeros((T, rows.shape[1]), np.float32)
    out[:min(T, len(rows))] = rows[:T]
    return out


def plan(n: int, bs: int, seed: int, shuffle: bool):
    """([NB, bs] row ids, [NB, bs] sample mask) of one pass."""
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    nb = (n + bs - 1) // bs
    idx = np.concatenate([order, order[:nb * bs - n]]).reshape(nb, bs)
    mask = (np.arange(nb * bs) < n).astype(np.float32).reshape(nb, bs)
    return idx, mask


class Split:
    """One split's utterances ready to batch: ``utts`` is a list of
    (audio [len, d_a], video [len, d_v], words, label)."""

    def __init__(self, utts: List, T: int, vocab: int):
        self.n = len(utts)
        self.audio = np.stack([pad(u[0], T) for u in utts])
        self.video = np.stack([pad(u[1], T) for u in utts])
        enc = [encode(u[2], T, vocab) for u in utts]
        self.ids, self.types, self.mask = (np.stack(x) for x in zip(*enc))
        self.labels = np.asarray([u[3] for u in utts], np.float32)

    def batch(self, rows: np.ndarray, sample_mask: np.ndarray,
              device) -> Dict[str, torch.Tensor]:
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return {"bert_sentences": t(self.ids[rows]),
                "bert_sentence_types": t(self.types[rows]),
                "bert_sentence_att_mask": t(self.mask[rows]),
                "audio": t(self.audio[rows]), "video": t(self.video[rows]),
                "labels": t(self.labels[rows]),
                "sample_mask": t(sample_mask)}
