"""Load-time transforms of a model's parameters (port of
`mxnet_tpu/predict.py::quantize_lm_params`; the predictor, export and
artifact loading of that module come with the deployment slice)."""
from __future__ import annotations

from .base import MXNetError


def quantize_lm_params(params, n_layers, mode="int8",
                       names=("wqkv", "wo", "w1", "w2")):
    """Quantize a transformer-LM parameter dict once at load:
    per-output-channel symmetric int8 for each layer's 2-D matmul
    weights, each becoming a `{"q": int8, "s": float32 per channel}` dict
    that `ops.quantization.maybe_quant_matmul` consumes. Embeddings, the
    positional table, layer norms and the LM head stay float (the final
    projection dominates the logit error), and so do 3-D MoE expert
    stacks. Returns a new dict; the caller keeps the float originals."""
    if str(mode) != "int8":
        raise MXNetError("weight quantization mode %r is not supported "
                         "(int8 or None)" % (mode,))
    from .ops.quantization import quantize_channelwise
    out = dict(params)
    for i in range(int(n_layers)):
        pre = "layer%d_" % i
        for name in names:
            w = out.get(pre + name)
            if w is None or getattr(w, "ndim", 0) != 2:
                continue
            q, s = quantize_channelwise(w, axis=1)
            out[pre + name] = {"q": q, "s": s}
    return out
