"""Op factory namespaces: ``sd.math``, ``sd.nn``, ``sd.rnn`` and
``sd.loss``.

Counterpart of ``deeplearning4j_tpu/autodiff/opsets.py`` over the ported
domains (reference: SDMath/SDNN/SDRNN/SDLoss). Thin builders over
``SameDiff._op``; the math lives in ``registry``. The namespaces of the
domains not ported yet (``sd.cnn``, ``sd.image``, ``sd.bitwise``,
``sd.linalg``, ``sd.random``) raise ``NotImplementedError`` on any
use."""
from __future__ import annotations


class _Namespace:
    def __init__(self, sd):
        self.sd = sd

    def _v(self, x):
        return self.sd._as_var(x)

    def _call(self, op, inputs, attrs=None, name=None, n_out=1):
        return self.sd._op(op, [self._v(i) for i in inputs], attrs,
                           name, n_out)


class SDMath(_Namespace):
    def __getattr__(self, op_name):
        """Any registered unary/binary op is reachable directly:
        sd.math.tanh(x), sd.math.atan2(a, b), ..."""
        from deeplearning4j_tpu_torch.autodiff.registry import (OP_REGISTRY,
                                                                UNPORTED,
                                                                get_op)
        if op_name in UNPORTED:
            get_op(op_name)               # raises, naming the domain
        if op_name.startswith("_") or op_name not in OP_REGISTRY:
            raise AttributeError(op_name)

        def fn(*inputs, name=None, **attrs):
            return self._call(op_name, list(inputs), attrs or None, name)

        return fn

    def add(self, a, b, name=None):
        return self._call("add", [a, b], name=name)

    def square(self, x, name=None):
        return self._call("square", [x], name=name)

    def standardize(self, x, axis=-1, name=None):
        return self._call("standardize", [x], {"axis": axis}, name)

    def moments(self, x, axis=None, name=None):
        return self._call("moments", [x], {"axis": axis}, name, n_out=2)

    def clip_by_value(self, x, lo, hi, name=None):
        return self._call("clip_by_value", [x],
                          {"clip_value_min": lo, "clip_value_max": hi},
                          name)

    def cumsum(self, x, axis=-1, name=None):
        return self._call("cumsum", [x], {"axis": axis}, name)

    def concat(self, inputs, axis=0, name=None):
        return self._call("concat", list(inputs), {"axis": axis}, name)

    def stack(self, inputs, axis=0, name=None):
        return self._call("stack", list(inputs), {"axis": axis}, name)

    def unstack(self, x, axis=0, num=None, name=None):
        if num is None:
            shape = self._v(x).shape
            if shape is None:     # op outputs carry no static shape
                raise ValueError(
                    "unstack of a computed tensor needs explicit num=")
            num = shape[axis]
        return self._call("unstack", [x], {"axis": axis}, name,
                          n_out=num)

    def split(self, x, num_splits, axis=0, name=None):
        return self._call("split", [x],
                          {"num_splits": num_splits, "axis": axis},
                          name, n_out=num_splits)

    def one_hot(self, idx, depth, name=None):
        return self._call("one_hot", [idx], {"depth": depth}, name)

    def segment_sum(self, data, segment_ids, num_segments=None,
                    name=None):
        return self._call("segment_sum", [data, segment_ids],
                          {"num_segments": num_segments}, name)

    def segment_mean(self, data, segment_ids, num_segments=None,
                     name=None):
        return self._call("segment_mean", [data, segment_ids],
                          {"num_segments": num_segments}, name)


class SDNN(_Namespace):
    def linear(self, x, w, b=None, name=None):
        y = self._call("matmul", [x, w], name=name)
        return y + b if b is not None else y

    def relu(self, x, name=None):
        return self._call("relu", [x], name=name)

    def gelu(self, x, name=None):
        return self._call("gelu", [x], name=name)

    def sigmoid(self, x, name=None):
        return self._call("sigmoid", [x], name=name)

    def tanh(self, x, name=None):
        return self._call("tanh", [x], name=name)

    def swish(self, x, name=None):
        return self._call("swish", [x], name=name)

    def elu(self, x, name=None):
        return self._call("elu", [x], name=name)

    def leaky_relu(self, x, alpha=0.01, name=None):
        return self._call("leaky_relu", [x], {"alpha": alpha}, name)

    def softmax(self, x, axis=-1, name=None):
        return self._call("softmax", [x], {"axis": axis}, name)

    def log_softmax(self, x, axis=-1, name=None):
        return self._call("log_softmax", [x], {"axis": axis}, name)

    def dropout(self, x, rate, name=None):
        return self._call("dropout", [x], {"rate": rate}, name)

    def layer_norm(self, x, gain=None, bias=None, axis=-1,
                   epsilon=1e-5, name=None):
        ins = [x] + ([gain] if gain is not None else []) + \
            ([bias] if bias is not None else [])
        return self._call("layer_norm", ins,
                          {"axis": axis, "epsilon": epsilon}, name)

    def batch_norm(self, x, mean, var, gamma, beta, epsilon=1e-5,
                   name=None):
        return self._call("batch_norm", [x, mean, var, gamma, beta],
                          {"epsilon": epsilon}, name)

    def dot_product_attention(self, q, k, v, mask=None, scale=None,
                              name=None):
        ins = [q, k, v] + ([mask] if mask is not None else [])
        attrs = {}
        if scale is not None:
            attrs["scale"] = scale
        return self._call("dot_product_attention", ins, attrs or None,
                          name)

    def multi_head_dot_product_attention(self, x, wq, wk, wv, wo,
                                         num_heads, mask=None,
                                         name=None):
        ins = [x, wq, wk, wv, wo] + ([mask] if mask is not None else [])
        return self._call("multi_head_dot_product_attention", ins,
                          {"num_heads": num_heads}, name)

    def embedding_lookup(self, table, ids, name=None):
        return self._call("gather", [table, ids], {"axis": 0}, name)

    def pad(self, x, paddings, constant=0.0, name=None):
        return self._call("pad", [x],
                          {"paddings": paddings, "constant": constant},
                          name)


class SDRNN(_Namespace):
    def lstm_cell(self, x, h_prev, c_prev, w, rw, b, name=None):
        return self._call("lstm_cell", [x, h_prev, c_prev, w, rw, b],
                          None, name, n_out=2)

    def gru_cell(self, x, h_prev, w, rw, b, name=None):
        return self._call("gru_cell", [x, h_prev, w, rw, b], None, name)

    def sru_cell(self, x, c_prev, w, b, name=None):
        return self._call("sru_cell", [x, c_prev, w, b], None, name,
                          n_out=2)


class SDLoss(_Namespace):
    def softmax_cross_entropy(self, labels, logits, weights=None,
                              label_smoothing=0.0, name=None):
        ins = [labels, logits] + ([weights] if weights is not None
                                  else [])
        return self._call("softmax_cross_entropy", ins,
                          {"label_smoothing": label_smoothing}, name)

    def sparse_softmax_cross_entropy(self, labels, logits, name=None):
        return self._call("sparse_softmax_cross_entropy",
                          [labels, logits], None, name)

    def sigmoid_cross_entropy(self, labels, logits, weights=None,
                              name=None):
        ins = [labels, logits] + ([weights] if weights is not None
                                  else [])
        return self._call("sigmoid_cross_entropy", ins, None, name)

    def mean_squared_error(self, labels, preds, weights=None, name=None):
        ins = [labels, preds] + ([weights] if weights is not None
                                 else [])
        return self._call("mean_squared_error", ins, None, name)

    def absolute_difference(self, labels, preds, weights=None,
                            name=None):
        ins = [labels, preds] + ([weights] if weights is not None
                                 else [])
        return self._call("absolute_difference", ins, None, name)

    def huber_loss(self, labels, preds, delta=1.0, name=None):
        return self._call("huber_loss", [labels, preds],
                          {"delta": delta}, name)

    def log_loss(self, labels, preds, name=None):
        return self._call("log_loss", [labels, preds], None, name)

    def hinge_loss(self, labels, logits, name=None):
        return self._call("hinge_loss", [labels, logits], None, name)

    def cosine_distance(self, a, b, axis=-1, name=None):
        return self._call("cosine_distance", [a, b], {"axis": axis},
                          name)


class UnportedNamespace:
    """The namespace of a domain not ported yet: any use raises."""

    def __init__(self, domain: str):
        self._domain = domain

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        raise NotImplementedError(
            f"sd.{name}: the {self._domain} domain is not ported yet "
            f"(ROADMAP.md, Queue A item 9)")
