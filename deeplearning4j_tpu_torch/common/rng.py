"""Explicit random keys for the port's random streams.

The JAX package threads ``jax.random`` keys through its training step:
a key per step, ``fold_in(key, layer index)`` per layer, ``split`` where
one layer needs two draws. ``RngKey`` plays that part here. A key is a
63-bit integer; ``fold_in`` and ``split`` derive child keys from it by a
fixed mixing function, and ``generator(device)`` gives a fresh
``torch.Generator`` on that device seeded with the key, so the draws
happen where the tensors live (on the card, the card's Philox).

Because a draw depends only on its key, a forward that runs again from
the same key draws the same masks: a rematerialized segment
(``torch.utils.checkpoint``) recomputes the values its first forward
made, and the stream does not depend on how the walk is segmented.
``torch.Generator`` streams cannot match ``jax.random``'s; tests that
need the JAX package's bits inject its masks or noise.
"""
from __future__ import annotations

from typing import List, Union

import torch

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
#: separates ``split`` children from ``fold_in`` children
_SPLIT_SALT = 0x5851F42D4C957F2D


def _mix(z: int) -> int:
    """splitmix64's finaliser: a bijection on 64-bit integers."""
    z = (z + _GOLDEN) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


class RngKey:
    """A key of an explicit random stream (a 63-bit seed)."""

    __slots__ = ("seed",)

    def __init__(self, seed: int):
        self.seed = int(seed) & (_MASK64 >> 1)

    def fold_in(self, data: int) -> "RngKey":
        """The child key for ``data`` (a layer index, a step)."""
        return RngKey(_mix(self.seed ^ _mix(int(data) & _MASK64)))

    def split(self, num: int = 2) -> List["RngKey"]:
        return [RngKey(_mix(self.seed ^ _mix(_SPLIT_SALT + i)))
                for i in range(num)]

    def generator(self, device: Union[str, torch.device]
                  ) -> torch.Generator:
        """A new generator on ``device`` seeded with this key."""
        return torch.Generator(device=device).manual_seed(self.seed)

    def __eq__(self, other) -> bool:
        return isinstance(other, RngKey) and other.seed == self.seed

    def __hash__(self) -> int:
        return hash(self.seed)

    def __repr__(self) -> str:
        return f"RngKey({self.seed:#x})"
