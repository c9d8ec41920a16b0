"""Functional-block scopes for the profiler.

Counterpart of ``deeplearning4j_tpu/common/layerprof.py``, cut to
:func:`scope`: a ``with`` block annotated as ``dl4j.<name>``, so a
``torch.profiler`` trace splits a step into the blocks a model names
(BERT: ``embeddings``, ``encoder.attention``, ``encoder.ffn``,
``pooler``, ``mlm_head``, ``nsp_head``, ``loss``, ``optimizer``). The
JAX package's cost-analysis attribution is not ported.
"""
from __future__ import annotations

import torch


def scope(name: str):
    """Annotate the with-block as block ``name`` in profiler traces."""
    return torch.profiler.record_function(f"dl4j.{name}")
