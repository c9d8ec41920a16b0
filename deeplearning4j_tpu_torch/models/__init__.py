"""The port's models: the zoo (``models.zoo``) and BERT."""
from .bert import Bert, BertConfig, BertForSequenceClassification

__all__ = ["Bert", "BertConfig", "BertForSequenceClassification"]
