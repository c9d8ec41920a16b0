"""Input preprocessors: shape adapters between layers.

Counterpart of ``deeplearning4j_tpu/nn/conf/preprocessors.py`` for the
four a convolutional or recurrent stack needs:
``FeedForwardToCnnPreProcessor`` (flat ``[b, h·w·c]`` to NHWC),
``CnnToFeedForwardPreProcessor`` (NHWC to flat),
``RnnToFeedForwardPreProcessor`` (``[b, t, f]`` to ``[b·t, f]``, time
folded into the batch) and ``FeedForwardToRnnPreProcessor`` (back). The
flat order is ``[h, w, c]`` row-major, the flattened NHWC buffer, as in
the JAX package, so dense weights after a flatten carry over unchanged.
All four are reshapes.
"""
from __future__ import annotations

from dataclasses import dataclass

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType


class InputPreProcessor:
    def pre_process(self, x):
        raise NotImplementedError

    def get_output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError

    def to_map(self) -> dict:
        return {"@class": type(self).__name__, **self.__dict__}

    @staticmethod
    def from_map(d: dict) -> "InputPreProcessor":
        d = dict(d)
        name = d.pop("@class")
        cls = _REGISTRY.get(name)
        if cls is None:
            raise NotImplementedError(
                f"preprocessor {name!r} is not ported yet (ported: "
                f"{sorted(_REGISTRY)})")
        return cls(**d)


@dataclass
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    height: int
    width: int
    channels: int

    def pre_process(self, x):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def get_output_type(self, input_type):
        return InputType.convolutional(self.height, self.width,
                                       self.channels)


@dataclass
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    height: int
    width: int
    channels: int

    def pre_process(self, x):
        return x.reshape(x.shape[0], -1)

    def get_output_type(self, input_type):
        return InputType.feed_forward(self.height * self.width *
                                      self.channels)


@dataclass
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """[b, t, f] -> [b*t, f] (the reference folds time into batch)."""

    def pre_process(self, x):
        return x.reshape(-1, x.shape[-1])

    def get_output_type(self, input_type):
        return InputType.feed_forward(input_type.size)


@dataclass
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    timesteps: int = -1

    def pre_process(self, x):
        return x.reshape(x.shape[0] // max(self.timesteps, 1),
                         self.timesteps, x.shape[-1])

    def get_output_type(self, input_type):
        return InputType.recurrent(input_type.size, self.timesteps)


_REGISTRY = {c.__name__: c for c in
             (FeedForwardToCnnPreProcessor, CnnToFeedForwardPreProcessor,
              RnnToFeedForwardPreProcessor, FeedForwardToRnnPreProcessor)}
