"""Op factory namespaces: ``sd.math``, ``sd.nn``, ``sd.cnn``,
``sd.rnn``, ``sd.loss``, ``sd.image``, ``sd.bitwise``, ``sd.linalg`` and
``sd.random``.

Counterpart of ``deeplearning4j_tpu/autodiff/opsets.py`` (reference:
SDMath/SDNN/SDCNN/SDRNN/SDLoss/SDImage/SDBitwise/SDLinalg/SDRandom).
Thin builders over ``SameDiff._op``, with the JAX package's op names and
attrs; the math lives in ``registry``."""
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
        from deeplearning4j_tpu_torch.autodiff.registry import OP_REGISTRY
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


class SDCNN(_Namespace):
    def conv2d(self, x, w, b=None, stride=(1, 1), padding="SAME",
               dilation=(1, 1), name=None):
        ins = [x, w] + ([b] if b is not None else [])
        return self._call("conv2d", ins,
                          {"stride": tuple(stride), "padding": padding,
                           "dilation": tuple(dilation)}, name)

    def conv1d(self, x, w, b=None, stride=1, padding="SAME", name=None):
        ins = [x, w] + ([b] if b is not None else [])
        return self._call("conv1d", ins,
                          {"stride": stride, "padding": padding}, name)

    def depthwise_conv2d(self, x, w, b=None, stride=(1, 1),
                         padding="SAME", name=None):
        ins = [x, w] + ([b] if b is not None else [])
        return self._call("depthwise_conv2d", ins,
                          {"stride": tuple(stride), "padding": padding},
                          name)

    def separable_conv2d(self, x, dw, pw, b=None, stride=(1, 1),
                         padding="SAME", name=None):
        ins = [x, dw, pw] + ([b] if b is not None else [])
        return self._call("separable_conv2d", ins,
                          {"stride": tuple(stride), "padding": padding},
                          name)

    def deconv2d(self, x, w, b=None, stride=(1, 1), padding="SAME",
                 name=None):
        ins = [x, w] + ([b] if b is not None else [])
        return self._call("deconv2d", ins,
                          {"stride": tuple(stride), "padding": padding},
                          name)

    def max_pooling2d(self, x, kernel=(2, 2), stride=(2, 2),
                      padding="VALID", name=None):
        return self._call("max_pool2d", [x],
                          {"kernel": tuple(kernel),
                           "stride": tuple(stride), "padding": padding},
                          name)

    def avg_pooling2d(self, x, kernel=(2, 2), stride=(2, 2),
                      padding="VALID", name=None):
        return self._call("avg_pool2d", [x],
                          {"kernel": tuple(kernel),
                           "stride": tuple(stride), "padding": padding},
                          name)

    def upsampling2d(self, x, scale=2, name=None):
        return self._call("upsampling2d", [x], {"scale": scale}, name)

    def im2col(self, x, kernel, stride=(1, 1), name=None):
        return self._call("im2col", [x],
                          {"kernel": tuple(kernel),
                           "stride": tuple(stride)}, name)


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


class SDImage(_Namespace):
    def resize_bilinear(self, x, size, name=None):
        return self._call("resize_bilinear", [x], {"size": tuple(size)},
                          name)

    def resize_nearest(self, x, size, name=None):
        return self._call("resize_nearest", [x], {"size": tuple(size)},
                          name)

    def crop_and_resize(self, img, boxes, box_idx, crop_size,
                        name=None):
        return self._call("crop_and_resize", [img, boxes, box_idx],
                          {"crop_size": tuple(crop_size)}, name)

    def non_max_suppression(self, boxes, scores, max_output_size,
                            iou_threshold=0.5, name=None):
        return self._call("non_max_suppression", [boxes, scores],
                          {"max_output_size": max_output_size,
                           "iou_threshold": iou_threshold}, name)

    def extract_image_patches(self, x, kernel, stride=(1, 1),
                              name=None):
        return self._call("extract_image_patches", [x],
                          {"kernel": tuple(kernel),
                           "stride": tuple(stride)}, name)


class SDBitwise(_Namespace):
    def and_(self, a, b, name=None):
        return self._call("bitwise_and", [a, b], None, name)

    def or_(self, a, b, name=None):
        return self._call("bitwise_or", [a, b], None, name)

    def xor(self, a, b, name=None):
        return self._call("bitwise_xor", [a, b], None, name)

    def left_shift(self, a, b, name=None):
        return self._call("left_shift", [a, b], None, name)

    def right_shift(self, a, b, name=None):
        return self._call("right_shift", [a, b], None, name)


class SDLinalg(_Namespace):
    def matmul(self, a, b, transpose_a=False, transpose_b=False,
               name=None):
        return self._call("matmul", [a, b],
                          {"transpose_a": transpose_a,
                           "transpose_b": transpose_b}, name)

    def cholesky(self, x, name=None):
        return self._call("cholesky", [x], None, name)

    def qr(self, x, name=None):
        return self._call("qr", [x], None, name, n_out=2)

    def svd(self, x, full_matrices=False, name=None):
        return self._call("svd", [x],
                          {"full_matrices": full_matrices}, name,
                          n_out=3)

    def lu(self, x, name=None):
        return self._call("lu", [x], None, name, n_out=3)

    def solve(self, a, b, name=None):
        return self._call("solve", [a, b], None, name)

    def triangular_solve(self, a, b, lower=True, name=None):
        return self._call("triangular_solve", [a, b], {"lower": lower},
                          name)

    def inverse(self, x, name=None):
        return self._call("matrix_inverse", [x], None, name)

    def det(self, x, name=None):
        return self._call("matrix_determinant", [x], None, name)


class SDRandom(_Namespace):
    def normal(self, mean, stddev, shape, name=None):
        return self._call("random_normal", [],
                          {"mean": mean, "stddev": stddev,
                           "shape": tuple(shape)}, name)

    def uniform(self, low, high, shape, name=None):
        return self._call("random_uniform", [],
                          {"min": low, "max": high,
                           "shape": tuple(shape)}, name)

    def bernoulli(self, prob, shape, name=None):
        return self._call("random_bernoulli", [],
                          {"prob": prob, "shape": tuple(shape)}, name)
