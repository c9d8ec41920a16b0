"""BERT's input pipeline: WordPiece tokenization and ``BertIterator``."""
from .bert_iterator import BertIterator
from .tokenization import BertWordPieceTokenizer

__all__ = ["BertIterator", "BertWordPieceTokenizer"]
