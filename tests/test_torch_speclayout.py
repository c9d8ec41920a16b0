"""The port's ``parallel/speclayout.SpecLayout`` against the JAX
package's, on the CPU: the specs ``infer_entry``, ``infer`` and
``infer_stages`` give (rendered as tuples), and ``tp_param_bytes``, on
``tests/test_pipeline.py``'s MLP and graph, the conv + BatchNormalization
graph of ``tests/test_torch_parallel.py`` (4-D kernels stay whole) and
the masked attention classifier (square projections column-first), each
from the JAX package's weights, on the meshes of ``tests/test_2d_
parallel.py`` and ``tests/test_pipeline.py``."""
import functools

import numpy as np
import pytest
from torch_parity import one_intraop_thread  # noqa: F401

from deeplearning4j_tpu.parallel import SpecLayout as JSpecLayout
from deeplearning4j_tpu.parallel import StagePartition as JPartition
from deeplearning4j_tpu.parallel.speclayout import \
    tp_param_bytes as jax_tp_param_bytes
from deeplearning4j_tpu_torch.parallel import SpecLayout, StagePartition
from deeplearning4j_tpu_torch.parallel.mesh import PartitionSpec as P
from deeplearning4j_tpu_torch.parallel.speclayout import tp_param_bytes
from test_torch_pipeline_trainer import jax_axes_mesh, pair, port_mesh


def classifier():
    from test_torch_attention_layers import _classifier_pair
    return _classifier_pair()


NETS = {"mlp": lambda: pair("mlp", "sgd"), "graph": lambda: pair("graph",
                                                                "adam"),
        "bn_graph": lambda: pair("bn_graph", "nesterovs"),
        "classifier": classifier}


@functools.lru_cache(maxsize=None)
def net_pair(name):
    """The JAX network and the port's, built once a test process."""
    return NETS[name]()
MESHES = {"dp4tp2": {"data": 4, "model": 2},
          "dp2tp2pp2": {"data": 2, "model": 2, "pipe": 2},
          "tp8": {"data": 1, "model": 8}}


def render(specs):
    return {k: {n: (tuple(ls.compute), tuple(ls.resident))
                for n, ls in sub.items()} for k, sub in specs.items()}


@pytest.mark.parametrize("net", sorted(NETS))
def test_infer_equals_jax(net):
    """On each mesh of MESHES, with and without the data residency."""
    jnet, tnet = net_pair(net)
    for mesh, axes in MESHES.items():
        jl = JSpecLayout(jax_axes_mesh(axes))
        tl = SpecLayout(port_mesh(axes))
        assert (tl.tp, tl.dp, tl.pp) == (jl.tp, jl.dp, jl.pp), mesh
        for over_data in (False, True):
            want = jl.infer(jnet.params, shard_over_data=over_data)
            got = tl.infer(tnet.params, shard_over_data=over_data)
            assert render(got) == render(want), (mesh, over_data)
            for k in tnet.params:
                assert render({k: tl.infer_entry(tnet.params[k],
                                                 over_data)}) == \
                    render({k: jl.infer_entry(jnet.params[k], over_data)})
            assert tp_param_bytes(tnet.params, got) == \
                jax_tp_param_bytes(jnet.params, want)
        if net != "bn_graph":
            assert tl.infer(tnet.params), "nothing to shard"


@pytest.mark.parametrize("net", sorted(NETS))
def test_infer_stages_equals_jax(net):
    """Per-stage specs on the {data: 2, model: 2, pipe: 2} mesh equal
    the JAX package's, and equal each entry's 2D specs; ``pipe`` never
    appears in one."""
    jnet, tnet = net_pair(net)
    axes = MESHES["dp2tp2pp2"]
    jpart = JPartition.build(list(jnet.params), jnet.params, 2)
    tpart = StagePartition.build(list(tnet.params), tnet.params, 2)
    assert tpart.boundaries == jpart.boundaries
    jst = JSpecLayout(jax_axes_mesh(axes)).infer_stages(jnet.params, jpart)
    tst = SpecLayout(port_mesh(axes)).infer_stages(tnet.params, tpart)
    assert [render(s) for s in tst] == [render(s) for s in jst]
    flat = render(SpecLayout(port_mesh({"data": 2, "model": 2})).infer(
        tnet.params))
    for stage in tst:
        for k, specs in render(stage).items():
            assert specs == flat[k]
            for c, r in specs.values():
                assert "pipe" not in c + r


def test_column_first_and_the_resident_rules():
    """A square out-projection is column (column is tested first); a
    column bias pairs with its weight's width; the ZeRO residency adds
    ``data`` on the free dimension only where it divides."""
    lay = SpecLayout(port_mesh({"data": 4, "model": 2}))
    rng = np.random.RandomState(0)
    entry = {"Wo": rng.randn(768, 768), "b": rng.randn(768),
             "W2": rng.randn(6, 3), "g": rng.randn(5)}
    specs = lay.infer_entry(entry, shard_over_data=True)
    assert specs["Wo"].compute == P(None, "model")
    assert specs["Wo"].resident == P("data", "model")
    assert specs["b"] == (P("model"), P("model"))
    assert specs["W2"] == (P("model", None), P("model", None))
    assert "g" not in specs
    # a nested entry (stored flat with '/' names) gets no specs
    assert lay.infer_entry({"a/W": rng.randn(4, 4)}) == {}
