"""ONNX model import (port of `mxnet_tpu/contrib/onnx/`; parity:
python/mxnet/contrib/onnx onnx_mxnet API).

Implemented without the `onnx` package: the model file's protobuf wire
format is decoded directly (see ``wire.py``) and translated onto the
Symbol DAG (``importer.py``).
"""
from __future__ import annotations

from .importer import OnnxModel, translate


def import_model(model_file):
    """Load an .onnx file -> (sym, arg_params, aux_params).

    Parity: reference ``contrib/onnx/_import/import_model.py:import_model``.
    Param dicts hold NDArrays keyed by the symbol's argument names (ONNX
    initializer names are preserved), on the current context.
    """
    from ...ndarray import NDArray
    with open(model_file, "rb") as f:
        data = f.read()
    sym, args, auxs = translate(OnnxModel(data))
    arg_params = {k: NDArray(v) for k, v in args.items()}
    aux_params = {k: NDArray(v) for k, v in auxs.items()}
    return sym, arg_params, aux_params


def get_model_metadata(model_file):
    """Input/output names and shapes of an .onnx file (parity:
    import_model.py:get_model_metadata)."""
    with open(model_file, "rb") as f:
        model = OnnxModel(f.read())
    init = model.initializers
    return {
        "input_tensor_data": [(n, s) for n, s in model.inputs
                              if n not in init],
        "output_tensor_data": list(model.outputs),
    }
