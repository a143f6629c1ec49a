"""Static-shape batch pipeline (the port's copy of
``mimrl_tpu.data.pipeline``).

Every batch has the same shapes: ``[bs, time_len, d]`` modality arrays,
and the text as ``[bs, time_len]`` token ids of the raw words or as dense
``[bs, time_len, d_t]`` features. Raw text is tokenised once, when the
pipeline is built, except AVEC2019's random-word text, which draws one
word per sentence and epoch (ref: Customization.py:66-76) from the
epoch's generator after its shuffle, and is tokenised then. A partial
final batch is cycle-padded with samples from the epoch start, and
``sample_mask`` marks the real rows (1) against the padding (0);
predictions and metrics keep only the real rows. Padding runs in the
C++ routine of ``native/`` (built at first use; a failed build raises),
as the JAX package's does; ``_pad_stack_plain`` is the numpy form it is
held against.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import numpy as np

from mimrl_tpu_torch.core.spans import span
from mimrl_tpu_torch.data.tokenizer import WordPieceTokenizer

SPLITS = ("train", "valid", "test")


def check_split(mode: str) -> None:
    if mode not in SPLITS:
        raise ValueError(f"unknown split {mode!r}")


@dataclass
class ArrayDataset:
    """Variable-length per-sample features + label arrays; the text is
    words (``text_words``) or dense features (``text_feat``), or absent."""

    text_words: Optional[List[List[str]]] = None
    text_feat: Optional[List[np.ndarray]] = None
    audio: List[np.ndarray] = field(default_factory=list)
    video: List[np.ndarray] = field(default_factory=list)
    # ordered label arrays; the Solver routes them per dataset
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


def _pad_stack_plain(arrays, time_len: int) -> np.ndarray:
    """[len_i, d] list -> [n, time_len, d] float32, in numpy."""
    return np.stack([_pad_time(a, time_len) for a in arrays])


def _pad_stack(arrays, time_len: int) -> np.ndarray:
    """``_pad_stack_plain`` by ``native.pad_stack`` for 2-D arrays (every
    loader's features); arrays of another number of dimensions take the
    numpy form, as in JAX."""
    if arrays and all(np.ndim(a) == 2 for a in arrays):
        from mimrl_tpu_torch import native

        return native.pad_stack(arrays, time_len)
    return _pad_stack_plain(arrays, time_len)


class BatchPipeline:
    """Iterates fixed-shape batches over an ArrayDataset.

    Batch dict fields:
      bert_sentences / bert_sentence_types / bert_sentence_att_mask
          [bs, time_len] int32 (raw text)
      text  [bs, time_len, d_t] float32 (dense text)
      audio [bs, time_len, d_a], video [bs, time_len, d_v]
      labels: list of [bs, ...] arrays
      sample_mask [bs] float32 (1 = real sample)
    """

    def __init__(
        self,
        dataset: ArrayDataset,
        batch_size: int,
        time_len: int,
        tokenizer: Optional[WordPieceTokenizer] = None,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        avec_random_word: bool = False,
    ):
        self.ds = dataset
        self.bs = batch_size
        self.time_len = time_len
        self.tokenizer = tokenizer
        self.shuffle = shuffle
        self.seed = seed
        self._passes = 0

        n = len(dataset)
        if n == 0:
            raise ValueError("empty dataset")
        if dataset.text_words is not None and tokenizer is None:
            raise ValueError("raw text needs a tokenizer")
        if drop_last and n >= batch_size:
            self.n_batches = n // batch_size
        else:
            self.n_batches = (n + batch_size - 1) // batch_size

        self._audio = _pad_stack(dataset.audio, time_len)
        self._video = _pad_stack(dataset.video, time_len)
        self._text_feat = (None if dataset.text_feat is None
                           else _pad_stack(dataset.text_feat, time_len))
        # the token ids of every sample, when they are the same each epoch
        self._tokens = None
        if dataset.text_words is not None and not avec_random_word:
            self._tokens = tokenizer.batch_encode(
                [" ".join(w[:time_len]) for w in dataset.text_words], time_len)

    def __len__(self) -> int:
        return self.n_batches

    @property
    def passes(self) -> int:
        """Passes begun over the data; pass ``p`` shuffles with the seed
        ``seed + p``. A resumed run sets it to carry on the shuffle."""
        return self._passes

    @passes.setter
    def passes(self, n: int) -> None:
        if n < 0:
            raise ValueError(f"passes={n}: must be >= 0")
        self._passes = int(n)

    @property
    def static_tensors(self) -> bool:
        """True when every tensor an epoch draws from is the same each
        epoch, so that an epoch is its index plan; AVEC's random-word text
        is the one exception."""
        return self.ds.text_words is None or self._tokens is not None

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

    def epoch_tokens(self, rng: np.random.Generator):
        """(ids, types, attention mask) [n, time_len] of every sample in
        dataset order for the epoch whose generator is ``rng`` (drawn from
        after the shuffle), or None without raw text. AVEC2019: one random
        word of each sentence (ref: Customization.py:66-76)."""
        if self.ds.text_words is None or self._tokens is not None:
            return self._tokens
        texts = []
        for sample in self.ds.text_words:
            words = []
            for sent in sample[: self.time_len]:
                parts = str(sent).lower().split(" ")
                words.append(parts[rng.integers(0, len(parts))])
            texts.append(" ".join(words))
        return self.tokenizer.batch_encode(texts, self.time_len)

    def next_epoch(self):
        """Begin a pass: (row ids, sample mask, tokens) of the epoch with
        the seed ``seed + passes``; ``passes`` advances by one."""
        rng = np.random.default_rng(self.seed + self._passes)
        idx_plan, mask_plan = self.epoch_index_plan(rng)
        tokens = self.epoch_tokens(rng)
        self._passes += 1
        return idx_plan, mask_plan, tokens

    def __iter__(self) -> Iterator[Dict]:
        plan = None
        for b in range(self.n_batches):
            with span("data/batch"):  # the first one draws the pass's plan
                if plan is None:
                    plan = self.next_epoch()
                batch = self._batch(*plan, b)
            yield batch

    def _batch(self, idx_plan, mask_plan, tokens, b: int) -> Dict:
        """Batch ``b`` of a pass's plan."""
        idx, mask = idx_plan[b], mask_plan[b]
        batch = {
            "audio": self._audio[idx],
            "video": self._video[idx],
            "labels": [np.asarray(lab)[idx] for lab in self.ds.labels],
            "sample_mask": mask,
        }
        if tokens is not None:
            ids, types, amask = tokens
            batch["bert_sentences"] = ids[idx]
            batch["bert_sentence_types"] = types[idx]
            batch["bert_sentence_att_mask"] = amask[idx]
        if self._text_feat is not None:
            batch["text"] = self._text_feat[idx]
        return batch


class _Failure:
    def __init__(self, error: Exception):
        self.error = error


def prefetch(iterator: Iterator, size: int = 2) -> Iterator:
    """Run ``iterator`` on a background thread, at most ``size`` items
    ahead (the port's copy of ``mimrl_tpu.data.pipeline.prefetch``: host
    batch assembly overlaps the device's work). An exception of the
    iterator is raised in the consumer. When the consumer stops early, the
    thread is stopped and joined."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    end = object()

    def producer():
        try:
            for item in iterator:
                q.put(item)
                if stop.is_set():
                    return
            q.put(end)
        except Exception as e:  # handed to the consumer, raised there
            q.put(_Failure(e))

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            with span("data/wait"):
                item = q.get()
            if item is end:
                return
            if isinstance(item, _Failure):
                raise item.error
            yield item
    finally:
        stop.set()
        while thread.is_alive():  # unblock a put, then let it see `stop`
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        thread.join()
