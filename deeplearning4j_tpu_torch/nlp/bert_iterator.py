"""BertIterator: wordpiece featurization and MLM masking.

A copy of ``deeplearning4j_tpu/nlp/bert_iterator.py`` (numpy only, with
a seeded ``np.random.RandomState``, so the same seed and vocabulary give
the same batches in both packages): sentences -> ``BertWordPieceTokenizer``
-> fixed-length ``[CLS] ... [SEP]`` id arrays with attention masks. Task
UNSUPERVISED applies the BERT MLM corruption (15 % of positions: 80 % ->
[MASK], 10 % -> a random id, 10 % kept) and emits ``mlm_labels`` with -1
on unmasked positions, the batch ``models.bert.Bert.pretrain_loss``
takes; task SEQ_CLASSIFICATION emits one-hot labels instead.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .tokenization import BertWordPieceTokenizer


class BertIterator:
    UNSUPERVISED = "UNSUPERVISED"
    SEQ_CLASSIFICATION = "SEQ_CLASSIFICATION"

    def __init__(self, tokenizer: BertWordPieceTokenizer,
                 sentences: Sequence,
                 max_length: int = 128,
                 batch_size: int = 16,
                 task: str = UNSUPERVISED,
                 labels: Optional[Sequence[int]] = None,
                 n_labels: Optional[int] = None,
                 mask_prob: float = 0.15,
                 seed: int = 0,
                 pad_token: str = "[PAD]",
                 cls_token: str = "[CLS]",
                 sep_token: str = "[SEP]",
                 mask_token: str = "[MASK]"):
        self.tk = tokenizer
        self.sentences = list(sentences)
        self.max_length = max_length
        self.batch_size = batch_size
        self.task = task
        self.labels = list(labels) if labels is not None else None
        self.n_labels = n_labels or (
            (max(self.labels) + 1) if self.labels else None)
        self.mask_prob = mask_prob
        self.seed = seed
        self.pad_id = tokenizer.id_of(pad_token)
        self.cls_id = tokenizer.id_of(cls_token)
        self.sep_id = tokenizer.id_of(sep_token)
        self.mask_id = tokenizer.id_of(mask_token)
        self._special = {self.pad_id, self.cls_id, self.sep_id}
        self._rng = np.random.RandomState(seed)
        self._pos = 0

    # -- iterator protocol (DataSetIterator-shaped) -------------------
    def reset(self):
        self._pos = 0
        self._rng = np.random.RandomState(self.seed)

    def has_next(self) -> bool:
        return self._pos < len(self.sentences)

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next()

    def batch(self) -> int:
        return self.batch_size

    # -- featurization ------------------------------------------------
    def _encode_one(self, sentence):
        """-> (ids, token_type_ids): segment 1 covers sentence B of a
        pair including its trailing [SEP] (BERT convention)."""
        types = None
        if isinstance(sentence, tuple):      # sentence pair
            a, b = sentence
            seg_a = ([self.cls_id]
                     + self.tk.encode(a)[: self.max_length - 3]
                     + [self.sep_id])
            seg_b = self.tk.encode(b)
            seg_b = seg_b[: self.max_length - len(seg_a) - 1] \
                + [self.sep_id]
            ids = seg_a + seg_b
            types = [0] * len(seg_a) + [1] * len(seg_b)
        else:
            ids = ([self.cls_id]
                   + self.tk.encode(sentence)[: self.max_length - 2]
                   + [self.sep_id])
        out = np.full(self.max_length, self.pad_id, np.int32)
        out[: len(ids)] = ids
        tt = np.zeros(self.max_length, np.int32)
        if types is not None:
            tt[: len(types)] = types
        return out, tt

    def _mask(self, ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """BERT MLM corruption. Returns (corrupted, labels)."""
        labels = np.full_like(ids, -1)
        out = ids.copy()
        vocab_size = len(self.tk.vocab)
        for i, t in enumerate(ids):
            if int(t) in self._special:
                continue
            if self._rng.rand() >= self.mask_prob:
                continue
            labels[i] = t
            r = self._rng.rand()
            if r < 0.8:
                out[i] = self.mask_id
            elif r < 0.9:
                out[i] = self._rng.randint(vocab_size)
            # else: keep original token
        return out, labels

    def next(self) -> Dict[str, np.ndarray]:  # noqa: A003
        if not self.has_next():
            raise StopIteration("iterator exhausted; call reset()")
        end = min(self._pos + self.batch_size, len(self.sentences))
        rows = [self._encode_one(self.sentences[i])
                for i in range(self._pos, end)]
        sl = slice(self._pos, end)
        self._pos = end
        ids = np.stack([r[0] for r in rows])
        tts = np.stack([r[1] for r in rows])
        att = (ids != self.pad_id).astype(np.float32)
        batch = {"input_ids": ids,
                 "token_type_ids": tts,
                 "attention_mask": att}
        if self.task == self.UNSUPERVISED:
            pairs = [self._mask(r) for r in ids]
            batch["input_ids"] = np.stack([p[0] for p in pairs])
            batch["mlm_labels"] = np.stack([p[1] for p in pairs])
        else:
            lab = np.asarray(self.labels[sl], np.int32)
            batch["labels"] = np.eye(self.n_labels,
                                     dtype=np.float32)[lab]
        return batch
