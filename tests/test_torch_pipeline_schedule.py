"""The pipeline fit path's schedule and partition in the port
(``parallel/pipeline.py``) against the JAX package's, on the CPU: the
GPipe and 1F1B tick tables for (S, M) in {(2, 4), (3, 5), (4, 4)}, their
peak residency and idle ticks, the hand-computed 1F1B table of
``tests/test_pipeline.py``, the byte-balanced ``StagePartition`` and the
graph's handoff sets on ``tests/test_pipeline.py``'s networks, the
conv + BatchNormalization graph and the attention classifier, and
``stage_submesh``."""
import pytest
from torch_parity import one_intraop_thread  # noqa: F401

from deeplearning4j_tpu.parallel import pipeline as jpipe
from deeplearning4j_tpu_torch.parallel import pipeline as tpipe
from deeplearning4j_tpu_torch.parallel.mesh import stage_submesh
from test_torch_pipeline_trainer import pair, port_mesh
from test_torch_speclayout import NETS, net_pair

SHAPES = [(2, 4), (3, 5), (4, 4)]


@pytest.mark.parametrize("kind", ["1f1b", "gpipe"])
@pytest.mark.parametrize("s_n,m_n", SHAPES)
def test_tick_tables_equal_jax(s_n, m_n, kind):
    got = tpipe.build_schedule(s_n, m_n, kind)
    assert got == jpipe.build_schedule(s_n, m_n, kind)
    assert tpipe.peak_residency(got, s_n) == \
        jpipe.peak_residency(got, s_n)
    assert tpipe.schedule_idle_ticks(got, s_n) == \
        jpipe.schedule_idle_ticks(got, s_n)
    if kind == "1f1b":
        assert tpipe.peak_residency(got, s_n) == [min(m_n, s_n - s)
                                                  for s in range(s_n)]
    else:
        assert tpipe.peak_residency(got, s_n) == [m_n] * s_n
    assert tpipe.bubble_fraction(s_n, m_n) == \
        jpipe.bubble_fraction(s_n, m_n)


def test_1f1b_hand_table_and_validation():
    F, B = "F", "B"
    assert tpipe.build_schedule(2, 4, "1f1b") == [
        ((F, 0), None), ((F, 1), (F, 0)), (None, (B, 0)), ((B, 0), (F, 1)),
        ((F, 2), (B, 1)), ((B, 1), (F, 2)), ((F, 3), (B, 2)),
        ((B, 2), (F, 3)), (None, (B, 3)), ((B, 3), None)]
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        tpipe.build_schedule(2, 4, "interleaved")
    with pytest.raises(ValueError, match="n_stages"):
        tpipe.build_schedule(0, 4)


@pytest.mark.parametrize("net", sorted(NETS))
def test_partition_and_handoff_sets_equal_jax(net):
    """2 and 3 stages (or the refusal where the network has fewer
    entries)."""
    jnet, tnet = net_pair(net)
    jad, tad = jpipe.make_stage_adapter(jnet), tpipe.make_stage_adapter(tnet)
    assert tad.entries() == jad.entries()
    for n_stages in (2, 3):
        if len(tad.entries()) < n_stages:
            with pytest.raises(ValueError, match="cannot split"):
                tpipe.StagePartition.build(tad.entries(), tnet.params,
                                           n_stages)
            continue
        jpart = jpipe.StagePartition.build(jad.entries(), jnet.params,
                                           n_stages)
        tpart = tpipe.StagePartition.build(tad.entries(), tnet.params,
                                           n_stages)
        assert tpart.boundaries == jpart.boundaries
        assert tpart.stage_param_bytes(tnet.params) == \
            jpart.stage_param_bytes(jnet.params)
        jad.part, tad.part = jpart, tpart
        jad.finalize()
        tad.finalize()
        if hasattr(jad, "incoming"):
            assert tad.incoming == jad.incoming
            assert tad.outgoing == jad.outgoing
        for e in tad.entries():
            assert tpart.stage_of(e) == jpart.stage_of(e)


def test_stage_submesh():
    mesh = port_mesh({"data": 2, "model": 2, "pipe": 2})
    sub = stage_submesh(mesh, 1)
    assert sub.shape == {"data": 2, "model": 2}
    assert sub.ranks == [1, 3, 5, 7]
    only = stage_submesh(port_mesh({"pipe": 2}), 0)
    assert only.shape == {"data": 1} and only.ranks == [0]
    with pytest.raises(ValueError, match="no 'pipe' axis"):
        stage_submesh(port_mesh({"data": 2}), 0)
    _, net = pair("mlp", "sgd")
    assert tpipe.StagePartition.build(["layer_0"], net.params, 1) \
        .boundaries == [0, 1]


def test_axis_replica_collectives_run_over_the_group():
    """``Replica.group("data")`` on a {data: 2, model: 2} thread mesh:
    the sum, the scattered sum, the gather and the broadcast of the
    data-parallel paths over the ranks of one model index only."""
    import torch
    mesh = port_mesh({"data": 2, "model": 2})
    vals = [torch.arange(4.0) + 10 * r for r in range(4)]

    def body(r):
        g = mesh.replica(r).group("data")
        return (g.rank, g.size, g.all_reduce_sum(vals[r]),
                g.reduce_scatter(vals[r]), g.all_gather(vals[r][:1]),
                g.broadcast(vals[r], 1))

    out = mesh.run(body)
    for r, (rank, size, total, part, gathered, bc) in enumerate(out):
        m = r % 2                         # the model index
        peers = [m, m + 2]                # the data group, data order
        assert (rank, size) == (r // 2, 2)
        want = vals[peers[0]] + vals[peers[1]]
        assert torch.equal(total, want)
        assert torch.equal(part, want[2 * rank:2 * rank + 2])
        assert torch.equal(gathered, torch.stack([vals[p][0]
                                                  for p in peers]))
        assert torch.equal(bc, vals[peers[1]])
