"""The bundled checkpoints through the port, on the CPU.

The port keeps byte-identical copies of the JAX package's
``models/pretrained/{lenet,charrnn,resnet_cifar}.zip`` and ``meta.json``
and restores them itself: the same outputs as the JAX package's
restores (1e-5), and the quality gates that ``meta.json`` and
``scripts/train_pretrained.py`` set (LeNet >= 0.99 on the synthetic
MNIST test split, ResNet-CIFAR >= 0.90 and its hard split inside
``HARD_GATE``, the char-RNN's next-character accuracy within 0.001 of
the recorded one on its training windows). A MultiLayerNetwork zip with
updater state goes port -> JAX -> port and training resumes where it
stopped.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.utils import ModelSerializer as JSerializer
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.mnist import MnistDataSetIterator
from deeplearning4j_tpu_torch.datasets.vision import (
    Cifar10DataSetIterator, synthetic_images)
from deeplearning4j_tpu_torch.models import (LeNet, ResNet50, char_rnn,
                                             lenet, pretrained_dir,
                                             pretrained_meta, resnet_cifar)
from deeplearning4j_tpu_torch.models.pretrained_gates import (
    HARD_GATE, eval_resnet_cifar_hard)
from deeplearning4j_tpu_torch.utils.serializer import (
    ModelSerializer, params_to_jax, updater_state_to_jax)
from torch_parity import one_intraop_thread  # noqa: F401,E402

ROOT = Path(__file__).resolve().parent.parent
ZIPS = ("lenet", "charrnn", "resnet_cifar")


def _inputs(name):
    r = np.random.RandomState(3)
    if name == "lenet":
        return r.rand(16, 784).astype(np.float32)
    if name == "resnet_cifar":
        return r.rand(16, 32, 32, 3).astype(np.float32)
    return np.eye(28, dtype=np.float32)[r.randint(0, 28, (8, 32))]


def test_bundled_files_are_byte_identical_copies():
    theirs = jzoo.pretrained_dir()
    assert pretrained_dir() != theirs
    names = sorted(p.name for p in theirs.iterdir())
    assert names == sorted(p.name for p in pretrained_dir().iterdir())
    for n in names:
        assert (pretrained_dir() / n).read_bytes() == \
            (theirs / n).read_bytes(), n
    assert pretrained_meta() == jzoo.pretrained_meta()


@pytest.mark.parametrize("name", ZIPS)
def test_restored_outputs_match_jax(name):
    path = pretrained_dir() / f"{name}.zip"
    jnet = JSerializer.restore_model(str(path))
    net = ModelSerializer.restore_model(path, "cpu")
    assert type(net).__name__ == type(jnet).__name__
    assert net.iteration_count == jnet.iteration_count
    x = _inputs(name)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=1e-5,
                               atol=1e-5)


def test_lenet_gate():
    ev = lenet(pretrained=True, device="cpu").evaluate(
        MnistDataSetIterator(512, train=False, num_examples=2000))
    assert ev.accuracy() >= 0.99


def test_resnet_cifar_gates():
    net = resnet_cifar(device="cpu")
    ev = net.evaluate(Cifar10DataSetIterator(512, train=False,
                                             num_examples=1000))
    assert ev.accuracy() >= 0.90
    hard = eval_resnet_cifar_hard(net)
    assert HARD_GATE[0] <= hard < HARD_GATE[1]
    assert hard == pytest.approx(
        pretrained_meta()["resnet_cifar"]["hard_split_accuracy"], abs=0.01)


def _train_pretrained_module():
    spec = importlib.util.spec_from_file_location(
        "train_pretrained", ROOT / "scripts" / "train_pretrained.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_charrnn_gate_and_text_copy():
    assert chip_smoke.CHARRNN_TEXT == _train_pretrained_module().CHARRNN_TEXT
    net, chars = char_rnn(device="cpu")
    x, y = chip_smoke.charrnn_windows(chars)
    assert x.shape == (134, 32, 28)
    acc = float((net.output(x).numpy().argmax(-1) == y.argmax(-1)).mean())
    want = pretrained_meta()["charrnn"]["next_char_accuracy"]
    assert abs(acc - want) <= 0.001, (acc, want)


def test_graph_evaluation_matches_jax():
    path = pretrained_dir() / "resnet_cifar.zip"
    jnet = JSerializer.restore_model(str(path))
    net = ModelSerializer.restore_model(path, "cpu")
    from deeplearning4j_tpu.datasets.vision import \
        Cifar10DataSetIterator as JCifar
    jev = jnet.evaluate(JCifar(64, train=False, num_examples=128))
    ev = net.evaluate(Cifar10DataSetIterator(64, train=False,
                                             num_examples=128))
    np.testing.assert_array_equal(ev.confusion_matrix(),
                                  jev.confusion_matrix())
    x, y = synthetic_images(32, 32, 32, 3, 10, train=False, seed=5)
    reg = net.evaluate_regression([DataSet(x, np.eye(10,
                                                     dtype=np.float32)[y])])
    assert reg.n == 32 and 0 < reg.mean_squared_error(0) < 1


def _trained_charrnn():
    from deeplearning4j_tpu_torch.models import TextGenerationLSTM
    net = TextGenerationLSTM(total_unique_characters=7, max_length=5,
                             units=8, layers=1).init("cpu")
    r = np.random.RandomState(0)
    eye = np.eye(7, dtype=np.float32)
    batches = [(eye[r.randint(0, 7, (3, 5))], eye[r.randint(0, 7, (3, 5))])
               for _ in range(3)]
    for x, y in batches[:2]:
        net.fit(x, y)
    return net, batches[2]


def test_updater_state_round_trips_port_jax_port(tmp_path):
    net, (x, y) = _trained_charrnn()
    ModelSerializer.write_model(net, tmp_path / "port.zip")
    jnet = JSerializer.restore_model(str(tmp_path / "port.zip"))
    assert jnet.iteration_count == 2
    JSerializer.write_model(jnet, str(tmp_path / "jax.zip"))
    back = ModelSerializer.restore_model(tmp_path / "jax.zip", "cpu")
    assert back.iteration_count == 2
    for k, v in params_to_jax(net.params, net.conf).items():
        np.testing.assert_array_equal(
            params_to_jax(back.params, back.conf)[k], v, err_msg=k)
    want = updater_state_to_jax(net.updater_states, net.conf)
    got = updater_state_to_jax(back.updater_states, back.conf)
    assert sorted(got) == sorted(want) and want
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # training resumes where it stopped: the same next step
    net.fit(x, y)
    back.fit(x, y)
    jnet.fit(x, y)
    assert back.score() == net.score()
    np.testing.assert_allclose(back.score(), float(jnet.score()),
                               rtol=2e-5)
    fresh = ModelSerializer.restore_model(tmp_path / "jax.zip", "cpu",
                                          load_updater=False)
    fresh.fit(x, y)
    # without its updater state the same step moves the weights elsewhere
    assert not torch.equal(fresh.params["layer_0"]["W"],
                           back.params["layer_0"]["W"])


def test_restore_checks_leaves(tmp_path):
    net, _ = _trained_charrnn()
    ModelSerializer.write_model(net, tmp_path / "small.zip")
    import zipfile
    with zipfile.ZipFile(tmp_path / "small.zip") as zin, \
            zipfile.ZipFile(tmp_path / "bad.zip", "w") as zout:
        for item in zin.namelist():
            data = zin.read(item)
            if item == "configuration.json":
                data = data.replace(b'"n_out": 8', b'"n_out": 9')
            zout.writestr(item, data)
    with pytest.raises(ValueError, match="shape"):
        ModelSerializer.restore_model(tmp_path / "bad.zip", "cpu")


def test_zoo_raises():
    with pytest.raises(ValueError, match="customizes"):
        LeNet(num_classes=5).init_pretrained(device="cpu")
    with pytest.raises(ValueError, match="silently ignored"):
        lenet(pretrained=True, device="cpu", num_classes=3)
    with pytest.raises(ValueError, match="only offered"):
        char_rnn(pretrained=False)
    net = ResNet50(num_classes=10, height=32, width=32).init_pretrained(
        pretrained_dir() / "resnet_cifar.zip", device="cpu")
    assert net.conf.vertices["output"].content.n_out == 10


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: ModelSerializer.restore_model(
                     pretrained_dir() / "lenet.zip"),
                 lambda: lenet(pretrained=True),
                 lambda: char_rnn(),
                 lambda: resnet_cifar()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_samediff_zip_of_a_linalg_graph_restores(tmp_path):
    """A SameDiff zip whose graph needs the linalg domain (a ``qr``)
    restores through ``restore_model`` in both packages and gives the
    JAX package's factors (the same LAPACK factorization on the CPU)."""
    import io
    import json
    import zipfile
    graph = {"variables": [{"name": "x", "type": "PLACEHOLDER",
                            "shape": [4, 3], "dtype": "float32"},
                           {"name": "q", "type": "ARRAY", "shape": None,
                            "dtype": None},
                           {"name": "r", "type": "ARRAY", "shape": None,
                            "dtype": None}],
             "ops": [{"op": "qr", "inputs": ["x"],
                      "outputs": ["q", "r"], "attrs": {}}]}
    buf = io.BytesIO()
    np.savez(buf)
    with zipfile.ZipFile(tmp_path / "sd.zip", "w") as zf:
        zf.writestr("graph.json", json.dumps(graph))
        zf.writestr("arrays.npz", buf.getvalue())
    x = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    p = ModelSerializer.restore_model(tmp_path / "sd.zip", "cpu")
    j = JSerializer.restore_model(str(tmp_path / "sd.zip"))
    got = p.output({"x": x}, ["q", "r"])
    want = j.output({"x": x}, ["q", "r"])
    for n in ("q", "r"):
        assert tuple(got[n].shape) == want[n].shape
        np.testing.assert_allclose(got[n].numpy(), want[n], rtol=2e-5,
                                   atol=1e-5, err_msg=n)
    np.testing.assert_allclose((got["q"] @ got["r"]).numpy(), x, atol=1e-5)
