"""BERT-compatible WordPiece tokenizer (host-side; the port's copy of
``mimrl_tpu.data.tokenizer``).

Loads a standard ``vocab.txt`` when one is given and otherwise falls
back to a deterministic hash-bucket vocabulary, so every pipeline
produces valid, static-shape token ids with no files. A ``vocab.txt``
tokenizer encodes batches with the C++ encoder of ``native/`` (built at
first use; a failed build raises), as the JAX package's does;
``batch_encode_plain`` is the Python form it is held against, and the
hash vocabulary always takes it.

``encode(..., max_length, pad_to_max)`` reproduces the
``encode_plus(max_length=SENT_LEN, truncation=True, padding='max_length')``
contract used by the Dec collate (ref: DataLoaderCMUDeclareLab.py:429-430).
"""

from __future__ import annotations

import hashlib
import logging
import unicodedata
from typing import Dict, List, Optional

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIAL_TOKENS = [PAD, UNK, CLS, SEP, MASK]


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _basic_tokenize(text: str, lower: bool = True) -> List[str]:
    if lower:
        text = text.lower()
    out: List[str] = []
    word = []
    for ch in text:
        if ch.isspace():
            if word:
                out.append("".join(word))
                word = []
        elif _is_punctuation(ch):
            if word:
                out.append("".join(word))
                word = []
            out.append(ch)
        else:
            word.append(ch)
    if word:
        out.append("".join(word))
    return out


class WordPieceTokenizer:
    def __init__(self, vocab: Dict[str, int], lower: bool = True,
                 max_word_chars: int = 100, hash_fallback: bool = False):
        self.vocab = vocab
        self.lower = lower
        self.max_word_chars = max_word_chars
        self.pad_id = vocab[PAD]
        self.unk_id = vocab[UNK]
        self.cls_id = vocab[CLS]
        self.sep_id = vocab[SEP]
        self.vocab_size = max(vocab.values()) + 1
        self._hash_fallback = hash_fallback

        self._native = None

    @classmethod
    def from_vocab_file(cls, path: str, lower: bool = True
                        ) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        tok = cls(vocab, lower=lower)
        tok.attach_native()
        return tok

    def attach_native(self) -> None:
        """Encode batches with ``native.NativeWordPiece`` from now on;
        the ids the vocabulary skips are named ``[unused{i}]``, as in
        JAX's ``_try_native``."""
        from mimrl_tpu_torch.native import NativeWordPiece

        tokens = [f"[unused{i}]" for i in range(self.vocab_size)]
        for tok_str, idx in self.vocab.items():
            tokens[idx] = tok_str
        self._native = NativeWordPiece(tokens, self.pad_id, self.unk_id,
                                       self.cls_id, self.sep_id, self.lower,
                                       plain=self.encode)

    @classmethod
    def hash_fallback(cls, vocab_size: int = 30522, lower: bool = True
                      ) -> "WordPieceTokenizer":
        """Deterministic hash-bucket vocabulary: any word maps to a stable
        id in [len(SPECIAL_TOKENS), vocab_size). No OOV, no files."""
        vocab = {tok: i for i, tok in enumerate(SPECIAL_TOKENS)}
        tok = cls(vocab, lower=lower, hash_fallback=True)
        tok.vocab_size = vocab_size
        return tok

    def _hash_id(self, word: str) -> int:
        n_special = len(SPECIAL_TOKENS)
        h = int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")
        return n_special + h % (self.vocab_size - n_special)

    def _wordpiece(self, word: str) -> List[int]:
        if self._hash_fallback:
            return [self._hash_id(word)]
        if len(word) > self.max_word_chars:
            return [self.unk_id]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece_id = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece_id = self.vocab[sub]
                    break
                end -= 1
            if piece_id is None:
                return [self.unk_id]
            ids.append(piece_id)
            start = end
        return ids

    def tokenize_to_ids(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in _basic_tokenize(text, self.lower):
            ids.extend(self._wordpiece(word))
        return ids

    def encode(self, text: str, max_length: int, pad_to_max: bool = True):
        """Returns (input_ids, token_type_ids, attention_mask) lists,
        [CLS] ... [SEP] framed, truncated and zero-padded to max_length."""
        body = self.tokenize_to_ids(text)[: max_length - 2]
        ids = [self.cls_id] + body + [self.sep_id]
        mask = [1] * len(ids)
        if pad_to_max and len(ids) < max_length:
            pad_n = max_length - len(ids)
            ids = ids + [self.pad_id] * pad_n
            mask = mask + [0] * pad_n
        types = [0] * len(ids)
        return ids, types, mask

    def batch_encode(self, texts: List[str], max_length: int):
        """(ids, type ids, attention mask), each ``[n, max_length]`` int32."""
        if self._native is not None:
            return self._native.batch_encode(texts, max_length)
        return self.batch_encode_plain(texts, max_length)

    def batch_encode_plain(self, texts: List[str], max_length: int):
        out_ids, out_types, out_mask = [], [], []
        for t in texts:
            ids, types, mask = self.encode(t, max_length)
            out_ids.append(ids)
            out_types.append(types)
            out_mask.append(mask)
        return (
            np.asarray(out_ids, np.int32),
            np.asarray(out_types, np.int32),
            np.asarray(out_mask, np.int32),
        )


def build_tokenizer(vocab_path: Optional[str] = None,
                    vocab_size: int = 30522) -> WordPieceTokenizer:
    if vocab_path:
        return WordPieceTokenizer.from_vocab_file(vocab_path)
    logging.getLogger("mimrl").warning(
        "No --bert_vocab supplied: using the deterministic HASH-BUCKET "
        "vocabulary (md5 word ids, no pretrained alignment). This is "
        "intended for hermetic tests/synthetic data only — real-data "
        "runs should pass --bert_vocab.")
    return WordPieceTokenizer.hash_fallback(vocab_size=vocab_size)
