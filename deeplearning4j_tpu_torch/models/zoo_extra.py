"""Model zoo, part 2: SqueezeNet and TextGenerationLSTM.

Counterpart of ``SqueezeNet`` in ``deeplearning4j_tpu/models/zoo_extra.py``,
the same graph definition field for field (layer names, ``FIRES``
table, the ``_conv`` helper), so the configuration JSON is the JAX
package's.

A ComputationGraph over NHWC 224x224x3 input, 1000 classes: a 3x3/s2
relu stem with bias and a 3x3/s2 max pool, eight fire modules (a 1x1
squeeze, then a 1x1 and a 3x3 expand side by side, concatenated on the
channels by a ``MergeVertex``) with two more max pools, a
``DropoutLayer(0.5)``, a 1x1 relu classifier conv, global average
pooling and a softmax output. Every convolution carries a bias and a
relu, so each is a conv-epilogue site: the 17 pointwise ones (the
squeeze and expand-1x1 of each fire module, and the classifier) run the
matmul kernel, the 9 others (the stem and each expand-3x3) the conv and
the epilogue kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch

from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.learning.updaters import Adam
from deeplearning4j_tpu_torch.lossfunctions import LossFunction
from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import MergeVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ConvolutionLayer, ConvolutionMode, DropoutLayer, GlobalPoolingLayer,
    OutputLayer, PoolingType, RnnOutputLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.conf.layers_recurrent import LSTM
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.weights import WeightInit


def _conv(n, k=(3, 3), s=(1, 1), act=Activation.IDENTITY, bias=False):
    return ConvolutionLayer(kernel_size=k, n_out=n, stride=s,
                            convolution_mode=ConvolutionMode.SAME,
                            has_bias=bias, activation=act)


@dataclass
class SqueezeNet:
    """Reference: org.deeplearning4j.zoo.model.SqueezeNet, NHWC: fire
    modules (squeeze 1x1 -> expand 1x1 | 3x3, concatenated)."""
    num_classes: int = 1000
    height: int = 224
    width: int = 224
    channels: int = 3
    seed: int = 123
    #: mixed precision: 'bfloat16' or 'float16' runs the forward math in
    #: that dtype over float32 parameters
    compute_dtype: Optional[str] = None

    #: (squeeze, expand) channels per fire module; 'M' = 3x3/s2 max pool
    FIRES = ((16, 64), (16, 64), (32, 128), "M", (32, 128),
             (48, 192), (48, 192), (64, 256), "M", (64, 256))

    def conf(self):
        g = (NeuralNetConfiguration.Builder().seed(self.seed)
             .updater(Adam(1e-3)).weight_init(WeightInit.RELU)
             .compute_data_type(self.compute_dtype)
             .graph_builder().add_inputs("input")
             .set_input_types(InputType.convolutional(
                 self.height, self.width, self.channels)))
        g.add_layer("stem", _conv(64, (3, 3), (2, 2),
                                  Activation.RELU, bias=True), "input")
        g.add_layer("stem_pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2),
            convolution_mode=ConvolutionMode.SAME), "stem")
        last = "stem_pool"
        fi = 0
        for item in self.FIRES:
            if item == "M":
                g.add_layer(f"pool{fi}", SubsamplingLayer(
                    kernel_size=(3, 3), stride=(2, 2),
                    convolution_mode=ConvolutionMode.SAME), last)
                last = f"pool{fi}"
                continue
            sq, ex = item
            n = f"fire{fi}"
            g.add_layer(f"{n}_sq", _conv(sq, (1, 1), act=Activation.RELU,
                                         bias=True), last)
            g.add_layer(f"{n}_e1", _conv(ex, (1, 1), act=Activation.RELU,
                                         bias=True), f"{n}_sq")
            g.add_layer(f"{n}_e3", _conv(ex, (3, 3), act=Activation.RELU,
                                         bias=True), f"{n}_sq")
            g.add_vertex(f"{n}_cat", MergeVertex(), f"{n}_e1", f"{n}_e3")
            last = f"{n}_cat"
            fi += 1
        g.add_layer("drop", DropoutLayer(dropout=0.5), last)
        g.add_layer("head_conv", _conv(self.num_classes, (1, 1),
                                       act=Activation.RELU, bias=True),
                    "drop")
        g.add_layer("gap", GlobalPoolingLayer(
            pooling_type=PoolingType.AVG), "head_conv")
        g.add_layer("output", OutputLayer(
            n_out=self.num_classes, loss_function=LossFunction.MCXENT,
            activation=Activation.SOFTMAX), "gap")
        return g.set_outputs("output").build()

    def init(self, device: Union[None, str, torch.device] = None, *,
             generator: Optional[torch.Generator] = None
             ) -> ComputationGraph:
        """Build and initialise the network on ``device`` (``None``: the
        card, raising when there is none)."""
        return ComputationGraph(self.conf()).init(device,
                                                  generator=generator)


@dataclass
class TextGenerationLSTM:
    """Reference: zoo.model.TextGenerationLSTM, as the JAX zoo builds
    it: ``layers`` LSTM(``units``, tanh) and a per-timestep softmax over
    ``total_unique_characters``, Adam(2e-3)."""
    total_unique_characters: int = 47
    max_length: int = 60
    units: int = 256
    layers: int = 2
    seed: int = 123

    def conf(self):
        b = (NeuralNetConfiguration.Builder().seed(self.seed)
             .updater(Adam(2e-3)).weight_init(WeightInit.XAVIER)
             .list())
        for _ in range(self.layers):
            b = b.layer(LSTM(n_out=self.units, activation=Activation.TANH))
        return (b.layer(RnnOutputLayer(
                    n_out=self.total_unique_characters,
                    loss_function=LossFunction.MCXENT,
                    activation=Activation.SOFTMAX))
                .set_input_type(InputType.recurrent(
                    self.total_unique_characters, self.max_length))
                .build())

    def init(self, device: Union[None, str, torch.device] = None, *,
             generator: Optional[torch.Generator] = None
             ) -> MultiLayerNetwork:
        """Build and initialise the network on ``device`` (``None``: the
        card, raising when there is none)."""
        return MultiLayerNetwork(self.conf()).init(device,
                                                   generator=generator)
