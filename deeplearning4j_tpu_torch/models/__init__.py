"""The port's models: the zoo (``models.zoo``, ``models.zoo_extra``),
BERT and the decoder LM."""
from .bert import Bert, BertConfig, BertForSequenceClassification
from .decoder import DecoderConfig, DecoderLM
from .zoo_extra import SqueezeNet

__all__ = ["Bert", "BertConfig", "BertForSequenceClassification",
           "DecoderConfig", "DecoderLM", "SqueezeNet"]
