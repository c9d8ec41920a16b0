"""WordPiece tokenization for BERT.

A copy of ``BertWordPieceTokenizer`` (and the ``_is_punct`` it uses)
from ``deeplearning4j_tpu/nlp/tokenization.py``: the code is
framework-free (it needs only ``unicodedata``), and the port keeps its
own copy rather than import the JAX package. Greedy
longest-match-first wordpiece over a basic whitespace-and-punctuation
split, ``##`` continuations; ``build_vocab`` makes a frequency vocabulary
from a corpus for tests and fixtures.
"""
from __future__ import annotations

import unicodedata
from typing import Iterable, List, Optional


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class BertWordPieceTokenizer:
    """Greedy longest-match-first wordpiece (reference:
    BertWordPieceTokenizer; algorithm identical to the original BERT
    tokenizer: basic split -> wordpiece with '##' continuations).
    """

    def __init__(self, vocab, lower_case: bool = True,
                 unk_token: str = "[UNK]",
                 max_chars_per_word: int = 100):
        if not isinstance(vocab, dict):
            vocab = {w: i for i, w in enumerate(vocab)}
        self.vocab = vocab
        self.inv_vocab = {i: w for w, i in vocab.items()}
        self.lower_case = lower_case
        self.unk_token = unk_token
        self.max_chars = max_chars_per_word

    # -- basic tokenization (whitespace + punctuation split) -----------
    def _basic(self, text: str) -> List[str]:
        if self.lower_case:
            text = text.lower()
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        out, cur = [], []
        for ch in text:
            if ch.isspace():
                if cur:
                    out.append("".join(cur))
                    cur = []
            elif _is_punct(ch):
                if cur:
                    out.append("".join(cur))
                    cur = []
                out.append(ch)
            else:
                cur.append(ch)
        if cur:
            out.append("".join(cur))
        return out

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return [self.unk_token]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out = []
        for w in self._basic(text):
            out.extend(self._wordpiece(w))
        return out

    def encode(self, text: str) -> List[int]:
        unk = self.vocab.get(self.unk_token, 0)
        return [self.vocab.get(t, unk) for t in self.tokenize(text)]

    def id_of(self, token: str) -> int:
        return self.vocab.get(token,
                              self.vocab.get(self.unk_token, 0))

    @staticmethod
    def build_vocab(corpus: Iterable[str], size: int = 1000,
                    lower_case: bool = True,
                    specials: Optional[List[str]] = None):
        """Frequency-based wordpiece vocab builder for tests/fixtures
        (whole words + character pieces; real deployments load a
        pretrained vocab file via ``from_vocab_file``)."""
        from collections import Counter
        specials = specials or ["[PAD]", "[UNK]", "[CLS]", "[SEP]",
                                "[MASK]"]
        tk = BertWordPieceTokenizer({}, lower_case=lower_case)
        words = Counter()
        chars = Counter()
        for line in corpus:
            for w in tk._basic(line):
                words[w] += 1
                chars.update(w)
                chars.update("##" + c for c in w[1:])
        vocab = list(specials)
        vocab += [c for c, _ in chars.most_common()]
        for w, _ in words.most_common():
            if len(vocab) >= size:
                break
            if w not in vocab:
                vocab.append(w)
        return {w: i for i, w in enumerate(vocab[:max(size,
                                                      len(specials))])}

    @staticmethod
    def from_vocab_file(path: str, lower_case: bool = True):
        with open(path, encoding="utf-8") as f:
            vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
        return BertWordPieceTokenizer(vocab, lower_case=lower_case)
