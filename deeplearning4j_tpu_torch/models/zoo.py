"""Model zoo: LeNet-5 and ResNet-50, and the bundled checkpoints.

Counterpart of ``LeNet`` and ``ResNet50`` in
``deeplearning4j_tpu/models/zoo.py``, the same builders field for field.

``init_pretrained()`` restores a checkpoint bundled under
``models/pretrained/`` (the JAX package's zips and ``meta.json``, copied
byte for byte, so the port reads nothing of the JAX package's tree):
``lenet.zip`` (synthetic MNIST), ``resnet_cifar.zip`` (the CIFAR-scale
ResNet: 32x32, stages ((2, 16), (2, 32))) and ``charrnn.zip`` (a
GravesLSTM(128) character model). ``meta.json`` records each one's
quality gate; ``lenet``, ``resnet_cifar`` and ``char_rnn`` are the
shortcuts.

LeNet-5 is a MultiLayerNetwork over flat 28x28x1 input: two 5x5
convolutions (20 and 50 channels, with bias, identity activation), each
followed by a 2x2 max pool, a 500-unit relu dense layer and a 10-class
softmax head, trained with Adam(1e-3). Its convolutions carry a bias,
so they are conv-epilogue sites.

ResNet-50 is a ComputationGraph of [3, 4, 6, 3]
bottleneck blocks over NHWC 224x224x3 input, 1000 classes. Every
convolution is SAME, bias-free, with an identity activation; every
BatchNormalization that follows it carries the relu (or identity
before the residual add), so the forward's 53 BatchNormalization sites
are the conv epilogue's.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple, Union

import torch

from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.learning.updaters import (Adam, IUpdater,
                                                       Nesterovs)
from deeplearning4j_tpu_torch.lossfunctions import LossFunction
from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import \
    ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer, BatchNormalization, ConvolutionLayer, ConvolutionMode,
    DenseLayer, GlobalPoolingLayer, OutputLayer, PoolingType,
    SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.weights import WeightInit

_Device = Union[None, str, torch.device]


def pretrained_dir() -> Path:
    """The bundled checkpoints and their ``meta.json``."""
    return Path(__file__).parent / "pretrained"


def pretrained_meta() -> dict:
    with open(pretrained_dir() / "meta.json") as fh:
        return json.load(fh)


class ZooModel:
    """Base of the zoo's models (reference: ZooModel):
    ``init_pretrained``."""

    #: name of the bundled checkpoint; None = no shipped weights
    pretrained_name: Optional[str] = None

    def init_pretrained(self, path=None, device: _Device = None):
        """Restore pretrained weights onto ``device`` (``None``: the
        card): the bundled checkpoint, or the zip at ``path``. A zip
        carries its own configuration, so fields customised on this
        instance cannot apply: with the bundled weights they raise."""
        from deeplearning4j_tpu_torch.utils.serializer import \
            ModelSerializer
        if path is None:
            name = self.pretrained_name
            if name is None:
                raise ValueError(
                    f"{type(self).__name__} has no bundled pretrained "
                    f"weights; pass an explicit checkpoint path")
            changed = [f.name for f in dataclasses.fields(self)
                       if f.default is not dataclasses.MISSING
                       and getattr(self, f.name) != f.default]
            if changed:
                raise ValueError(
                    f"{type(self).__name__}({', '.join(changed)}) "
                    f"customizes the architecture, but the bundled "
                    f"'{name}' checkpoint carries its own configuration: "
                    f"the customization would be silently ignored. Drop "
                    f"the kwargs, or pass an explicit checkpoint path "
                    f"trained with them.")
            path = pretrained_dir() / f"{name}.zip"
        return ModelSerializer.restore_model(path, device)


@dataclass
class LeNet(ZooModel):
    """Reference: org.deeplearning4j.zoo.model.LeNet (MNIST-class)."""
    pretrained_name = "lenet"
    num_classes: int = 10
    height: int = 28
    width: int = 28
    channels: int = 1
    seed: int = 123
    updater: Optional[IUpdater] = None

    def conf(self):
        return (NeuralNetConfiguration.Builder()
                .seed(self.seed)
                .updater(self.updater or Adam(1e-3))
                .weight_init(WeightInit.XAVIER)
                .list()
                .layer(ConvolutionLayer(kernel_size=(5, 5), n_out=20,
                                        stride=(1, 1),
                                        activation=Activation.IDENTITY))
                .layer(SubsamplingLayer(pooling_type=PoolingType.MAX,
                                        kernel_size=(2, 2),
                                        stride=(2, 2)))
                .layer(ConvolutionLayer(kernel_size=(5, 5), n_out=50,
                                        stride=(1, 1),
                                        activation=Activation.IDENTITY))
                .layer(SubsamplingLayer(pooling_type=PoolingType.MAX,
                                        kernel_size=(2, 2),
                                        stride=(2, 2)))
                .layer(DenseLayer(n_out=500, activation=Activation.RELU))
                .layer(OutputLayer(
                    n_out=self.num_classes,
                    loss_function=LossFunction.NEGATIVELOGLIKELIHOOD,
                    activation=Activation.SOFTMAX))
                .set_input_type(InputType.convolutional_flat(
                    self.height, self.width, self.channels))
                .build())

    def init(self, device: Union[None, str, torch.device] = None, *,
             generator: Optional[torch.Generator] = None
             ) -> MultiLayerNetwork:
        """Build and initialise the network on ``device`` (``None``: the
        card, raising when there is none)."""
        return MultiLayerNetwork(self.conf()).init(device,
                                                   generator=generator)


@dataclass
class ResNet50(ZooModel):
    """Reference: org.deeplearning4j.zoo.model.ResNet50, NHWC. Its
    bundled checkpoint is the CIFAR-scale variant (``resnet_cifar``):
    ``init_pretrained`` returns that graph, not the ImageNet-sized
    default."""
    pretrained_name = "resnet_cifar"
    num_classes: int = 1000
    height: int = 224
    width: int = 224
    channels: int = 3
    seed: int = 123
    updater: Optional[IUpdater] = None
    #: mixed precision: 'bfloat16' runs the forward math in bf16 over
    #: float32 parameters, BatchNormalization stats kept in float32
    compute_dtype: Optional[str] = None
    #: train in this many checkpointed segments of the topo walk
    #: (0: keep every activation)
    remat_segments: int = 0
    #: stage definitions: (n_blocks, bottleneck_width)
    STAGES: Tuple[Tuple[int, int], ...] = ((3, 64), (4, 128), (6, 256),
                                           (3, 512))

    def conf(self):
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater or Nesterovs(1e-1, 0.9))
             .weight_init(WeightInit.RELU)
             .l2(1e-4)
             .compute_data_type(self.compute_dtype)
             .remat_segments(self.remat_segments)
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(
                 self.height, self.width, self.channels)))

        def conv_bn(name, inp, n_out, kernel, stride, act=True):
            g.add_layer(f"{name}_conv",
                        ConvolutionLayer(
                            kernel_size=kernel, n_out=n_out,
                            stride=stride,
                            convolution_mode=ConvolutionMode.SAME,
                            has_bias=False,
                            activation=Activation.IDENTITY), inp)
            g.add_layer(f"{name}_bn",
                        BatchNormalization(
                            activation=Activation.RELU if act
                            else Activation.IDENTITY), f"{name}_conv")
            return f"{name}_bn"

        last = conv_bn("stem", "input", 64, (7, 7), (2, 2))
        g.add_layer("stem_pool",
                    SubsamplingLayer(pooling_type=PoolingType.MAX,
                                     kernel_size=(3, 3), stride=(2, 2),
                                     convolution_mode=ConvolutionMode.SAME),
                    last)
        last = "stem_pool"

        for si, (n_blocks, width) in enumerate(self.STAGES):
            for bi in range(n_blocks):
                name = f"s{si}b{bi}"
                stride = (2, 2) if (bi == 0 and si > 0) else (1, 1)
                a = conv_bn(f"{name}_a", last, width, (1, 1), stride)
                b = conv_bn(f"{name}_b", a, width, (3, 3), (1, 1))
                c = conv_bn(f"{name}_c", b, width * 4, (1, 1), (1, 1),
                            act=False)
                if bi == 0:
                    sc = conv_bn(f"{name}_sc", last, width * 4, (1, 1),
                                 stride, act=False)
                else:
                    sc = last
                g.add_vertex(f"{name}_add",
                             ElementWiseVertex(ElementWiseVertex.Op.Add),
                             c, sc)
                g.add_layer(f"{name}_relu",
                            ActivationLayer(activation=Activation.RELU),
                            f"{name}_add")
                last = f"{name}_relu"

        g.add_layer("avgpool",
                    GlobalPoolingLayer(pooling_type=PoolingType.AVG), last)
        g.add_layer("output",
                    OutputLayer(n_out=self.num_classes,
                                loss_function=LossFunction.MCXENT,
                                activation=Activation.SOFTMAX), "avgpool")
        return g.set_outputs("output").build()

    def init(self, device: Union[None, str, torch.device] = None, *,
             generator: Optional[torch.Generator] = None
             ) -> ComputationGraph:
        """Build and initialise the network on ``device`` (``None``: the
        card, raising when there is none)."""
        return ComputationGraph(self.conf()).init(device,
                                                  generator=generator)


# -- shortcuts over the bundled checkpoints ---------------------------------
def lenet(pretrained: bool = False, device: _Device = None, **kw):
    """LeNet-5; ``pretrained=True`` restores the bundled synthetic-MNIST
    checkpoint (its accuracy is in ``meta.json``)."""
    if pretrained:
        if kw:
            raise ValueError(
                f"lenet(pretrained=True) loads the bundled checkpoint "
                f"with its own architecture; architecture kwargs "
                f"{sorted(kw)} would be silently ignored: drop them or "
                f"build fresh with pretrained=False")
        return LeNet().init_pretrained(device=device)
    return LeNet(**kw).init(device)


def resnet_cifar(pretrained: bool = True, device: _Device = None):
    """The bundled CIFAR-scale ResNet checkpoint, or that architecture
    freshly initialised."""
    if pretrained:
        return ResNet50().init_pretrained(device=device)
    return ResNet50(num_classes=10, height=32, width=32,
                    STAGES=((2, 16), (2, 32))).init(device)


def char_rnn(pretrained: bool = True, device: _Device = None):
    """The bundled GravesLSTM character model: ``(net, chars)``, the
    vocabulary (index -> char) from ``meta.json``."""
    if not pretrained:
        raise ValueError("char_rnn is only offered as the bundled "
                         "checkpoint; build a TextGenerationLSTM "
                         "otherwise")
    from deeplearning4j_tpu_torch.utils.serializer import ModelSerializer
    net = ModelSerializer.restore_model(pretrained_dir() / "charrnn.zip",
                                        device)
    return net, pretrained_meta()["charrnn"]["chars"]
