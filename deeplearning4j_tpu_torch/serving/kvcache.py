"""Paged KV-cache residency for generative serving.

Counterpart of ``deeplearning4j_tpu/serving/kvcache.py``. Decode is
bound by KV-cache memory: every live sequence keeps ``2 * layers * len *
heads * head_dim`` values resident between tokens. Allocating them per
request as contiguous max-length tensors wastes the gap between a
sequence's length and its ``max_tokens``; paged attention (vLLM) carves
one preallocated pool into fixed-size blocks instead:

- One pair of tensors per pool, ``k`` / ``v`` ``[n_layers, num_blocks,
  block_size, n_heads, head_dim]`` on an explicit device; ``pool.k[l]``
  is the ``[num_blocks, block, heads, head_dim]`` layout the decode
  kernel reads through.
- A **block table** per sequence: the ordered block ids holding its
  tokens, shared across layers (token ``t`` of layer ``l`` lives at
  ``k[l, table[t // block_size], t % block_size]``).
- **Block 0 is reserved scratch**: padded decode rows and padded prompt
  positions write their K/V there, so the step never branches on
  liveness. It is never handed to a sequence.
- alloc / extend / free with occupancy accounting: gauges
  ``dl4j_kv_pool_blocks{state=free|live}`` and ``dl4j_kv_pool_bytes``;
  exhaustion counts ``dl4j_kv_pool_shed_total`` and raises
  :class:`PoolExhausted` (a ``ShedError``: HTTP 429 with a measured
  ``Retry-After`` upstream).

The decode step writes into the pool tensors in place (the JAX package
stores a functional update back), so the pool never holds a second
copy. :func:`pool_report` lists every live pool and
:func:`pool_resident_bytes` sums them: ``common/diagnostics.memory_report``
joins both in as their own resident class (a ``sys.modules`` lookup on
its side, no import edge).
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.common import telemetry
from deeplearning4j_tpu_torch.common.environment import resolve_device
from deeplearning4j_tpu_torch.serving.admission import ShedError

#: live pools, for pool_report (weak: a retired pool is not kept alive)
_pools: "weakref.WeakSet[KVBlockPool]" = weakref.WeakSet()

#: names the pool dtype accepts (``DL4J_TORCH_KV_DTYPE`` too)
KV_DTYPES = {"float32": torch.float32, "bf16": torch.bfloat16,
             "bfloat16": torch.bfloat16}


def kv_dtype(name: Union[str, torch.dtype, None]) -> torch.dtype:
    """A pool dtype from a name (``float32``, ``bf16``) or a dtype."""
    if isinstance(name, torch.dtype):
        if name not in KV_DTYPES.values():
            raise ValueError(f"KV pool dtype {name} is not float32 or "
                             f"bfloat16")
        return name
    key = (name or "float32").strip()
    if key not in KV_DTYPES:
        raise ValueError(f"KV pool dtype {name!r} is not one of "
                         f"{sorted(KV_DTYPES)}")
    return KV_DTYPES[key]


class PoolExhausted(ShedError):
    """The KV pool has no free block for an alloc/extend: shed (HTTP
    429) with a measured ``Retry-After`` instead of queueing."""

    def __init__(self, retry_after_s: float = 1.0):
        super().__init__("kv_pool", retry_after_s)


def _blocks_gauge() -> telemetry.Gauge:
    return telemetry.gauge(
        "dl4j_kv_pool_blocks",
        "KV-cache pool blocks by state (free | live) per pool; block 0 is "
        "reserved scratch and counted in neither state")


def _bytes_gauge() -> telemetry.Gauge:
    return telemetry.gauge(
        "dl4j_kv_pool_bytes",
        "preallocated device bytes of a KV-cache pool (k + v; constant "
        "for the pool's lifetime)")


def _shed_counter() -> telemetry.Counter:
    return telemetry.counter(
        "dl4j_kv_pool_shed_total",
        "generative requests shed because the KV pool had no free block "
        "(HTTP 429 + measured Retry-After upstream)")


class KVBlockPool:
    """A paged KV-cache pool: preallocated k/v tensors plus the host-side
    block allocator.

    ``alloc(seq_id, n_tokens)`` reserves a new sequence's block table,
    ``extend(seq_id)`` grows it one token (chaining a block at each
    ``block_size`` boundary), ``free(seq_id)`` returns its blocks,
    callable mid-batch. ``device`` is where the tensors live (``None``:
    the card); ``dtype`` ``float32`` (default) or ``bf16``;
    ``device_arrays=False`` keeps allocator-only CPU tensors (tests,
    sizing)."""

    def __init__(self, n_layers: int, num_blocks: int, block_size: int,
                 n_heads: int, head_dim: int, *, dtype="float32",
                 device=None, name: str = "model",
                 device_arrays: bool = True):
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is "
                             "reserved scratch)")
        self.n_layers = int(n_layers)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.n_heads = int(n_heads)
        self.head_dim = int(head_dim)
        self.name = name
        shape = (self.n_layers, self.num_blocks, self.block_size,
                 self.n_heads, self.head_dim)
        dev = resolve_device(device) if device_arrays \
            else torch.device("cpu")
        dt = kv_dtype(dtype)
        self.k = torch.zeros(shape, dtype=dt, device=dev)
        self.v = torch.zeros(shape, dtype=dt, device=dev)
        self._lock = threading.RLock()
        #: free block ids, LIFO (block 0 reserved)
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._tables: Dict[object, List[int]] = {}
        self._lengths: Dict[object, int] = {}
        _pools.add(self)
        if telemetry.enabled():
            _bytes_gauge().set(self.pool_bytes, pool=self.name)
            self._export_occupancy()

    # -- sizing ----------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.k.device

    @property
    def pool_bytes(self) -> int:
        """Preallocated bytes (k + v)."""
        return 2 * self.k.numel() * self.k.element_size()

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1          # minus the scratch block

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks a sequence of ``n_tokens`` occupies (ceil, at least 1)."""
        return max(1, -(-int(n_tokens) // self.block_size))

    # -- occupancy -------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def live_blocks(self) -> int:
        with self._lock:
            return sum(len(t) for t in self._tables.values())

    @property
    def occupancy(self) -> float:
        """live / usable, in [0, 1]."""
        return self.live_blocks / max(1, self.usable_blocks)

    @property
    def live_sequences(self) -> int:
        with self._lock:
            return len(self._tables)

    def _export_occupancy(self) -> None:
        if not telemetry.enabled():
            return
        g = _blocks_gauge()
        g.set(len(self._free), pool=self.name, state="free")
        g.set(sum(len(t) for t in self._tables.values()), pool=self.name,
              state="live")

    # -- lifecycle -------------------------------------------------------
    def alloc(self, seq_id, n_tokens: int) -> List[int]:
        """Reserve blocks for a new sequence of ``n_tokens`` prompt
        tokens; raises :class:`PoolExhausted` (counting the shed) without
        a partial allocation when the pool cannot hold it."""
        need = self.blocks_for(n_tokens)
        with self._lock:
            if seq_id in self._tables:
                raise ValueError(f"sequence {seq_id!r} already has a "
                                 f"block table")
            if need > len(self._free):
                _shed_counter().inc(pool=self.name)
                raise PoolExhausted()
            blocks = [self._free.pop() for _ in range(need)]
            self._tables[seq_id] = blocks
            self._lengths[seq_id] = int(n_tokens)
            self._export_occupancy()
            return list(blocks)

    def extend(self, seq_id, n_tokens: int = 1) -> List[int]:
        """Grow a sequence by ``n_tokens``, chaining table entries across
        ``block_size`` boundaries; returns the table. On exhaustion
        raises :class:`PoolExhausted` with the sequence's blocks
        intact."""
        with self._lock:
            if seq_id not in self._tables:
                raise KeyError(f"unknown sequence {seq_id!r}")
            new_len = self._lengths[seq_id] + int(n_tokens)
            need = self.blocks_for(new_len) - len(self._tables[seq_id])
            if need > len(self._free):
                _shed_counter().inc(pool=self.name)
                raise PoolExhausted()
            for _ in range(need):
                self._tables[seq_id].append(self._free.pop())
            self._lengths[seq_id] = new_len
            if need:
                self._export_occupancy()
            return list(self._tables[seq_id])

    def free(self, seq_id) -> int:
        """Return a sequence's blocks to the pool (EOS, max_tokens, a
        disconnect: all mid-batch). Idempotent; returns the number of
        blocks released."""
        with self._lock:
            blocks = self._tables.pop(seq_id, None)
            self._lengths.pop(seq_id, None)
            if not blocks:
                return 0
            self._free.extend(reversed(blocks))
            self._export_occupancy()
            return len(blocks)

    def table(self, seq_id) -> List[int]:
        with self._lock:
            return list(self._tables[seq_id])

    def length(self, seq_id) -> int:
        with self._lock:
            return self._lengths[seq_id]

    def padded_table(self, seq_id, max_blocks: int) -> np.ndarray:
        """The sequence's block table as a fixed-width int32 row padded
        with the scratch block 0."""
        t = self.table(seq_id)
        if len(t) > max_blocks:
            raise ValueError(f"sequence {seq_id!r} spans {len(t)} blocks "
                             f"> table width {max_blocks}")
        return np.asarray(t + [0] * (max_blocks - len(t)), np.int32)

    def report(self) -> dict:
        return {
            "pool": self.name,
            "bytes": self.pool_bytes,
            "dtype": str(self.k.dtype).replace("torch.", ""),
            "device": str(self.device),
            "blocks": {"free": self.free_blocks, "live": self.live_blocks,
                       "reserved": 1, "total": self.num_blocks},
            "occupancy": round(self.occupancy, 4),
            "live_sequences": self.live_sequences,
            "block_tokens": self.block_size,
            "layout": [self.n_layers, self.num_blocks, self.block_size,
                       self.n_heads, self.head_dim],
        }


def pool_report() -> List[dict]:
    """Reports of every live pool, by name."""
    return sorted((p.report() for p in list(_pools)),
                  key=lambda r: r["pool"])


def pool_resident_bytes() -> int:
    """Total preallocated KV bytes across live pools."""
    return sum(p.pool_bytes for p in list(_pools))
