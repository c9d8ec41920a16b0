"""The port's models: the zoo (``models.zoo``, ``models.zoo_extra``)
with its bundled checkpoints, BERT, the decoder LM and the distributed
Transformer LM."""
from .bert import Bert, BertConfig, BertForSequenceClassification
from .decoder import DecoderConfig, DecoderLM
from .transformer import DistributedTransformerLM, TransformerLMConfig
from .zoo import (LeNet, ResNet50, char_rnn, lenet, pretrained_dir,
                  pretrained_meta, resnet_cifar)
from .zoo_extra import SqueezeNet, TextGenerationLSTM

__all__ = ["Bert", "BertConfig", "BertForSequenceClassification",
           "DecoderConfig", "DecoderLM", "DistributedTransformerLM",
           "LeNet", "ResNet50", "SqueezeNet", "TextGenerationLSTM",
           "TransformerLMConfig", "char_rnn", "lenet", "pretrained_dir",
           "pretrained_meta", "resnet_cifar"]
