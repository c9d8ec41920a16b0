"""The port's models: the zoo (``models.zoo``, ``models.zoo_extra``)
with its bundled checkpoints, BERT and the decoder LM."""
from .bert import Bert, BertConfig, BertForSequenceClassification
from .decoder import DecoderConfig, DecoderLM
from .zoo import (LeNet, ResNet50, char_rnn, lenet, pretrained_dir,
                  pretrained_meta, resnet_cifar)
from .zoo_extra import SqueezeNet, TextGenerationLSTM

__all__ = ["Bert", "BertConfig", "BertForSequenceClassification",
           "DecoderConfig", "DecoderLM", "LeNet", "ResNet50", "SqueezeNet",
           "TextGenerationLSTM", "char_rnn", "lenet", "pretrained_dir",
           "pretrained_meta", "resnet_cifar"]
