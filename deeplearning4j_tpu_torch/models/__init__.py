"""The port's models: the zoo (``models.zoo``), BERT and the decoder LM."""
from .bert import Bert, BertConfig, BertForSequenceClassification
from .decoder import DecoderConfig, DecoderLM

__all__ = ["Bert", "BertConfig", "BertForSequenceClassification",
           "DecoderConfig", "DecoderLM"]
