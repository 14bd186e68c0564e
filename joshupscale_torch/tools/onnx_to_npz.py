"""Convert an ONNX model's weights to a params ``.npz``.

Port of ``tools/onnx_to_npz.py``: every initializer of the graph, under
its name normalized to a dotted layer path (``_normalize``: tf2onnx's
``.../generator/conv_1/Conv2D/ReadVariableOp:0`` becomes
``generator.conv_1``), conv kernels transposed from ONNX's OIHW back to
HWIO and deconv kernels from IOHW to ``(kh, kw, O, I)`` (one
permutation serves both), the reference's layouts.  Reads the file with
the port's own codec (``export.onnx_minimal``); the ``onnx`` package is
not needed.

    python -m joshupscale_torch.tools.onnx_to_npz model.onnx weights.npz
"""

from __future__ import annotations

import re
import sys
from typing import Dict, Tuple

import numpy as np


def load_graph(onnx_path: str) -> Tuple[Dict[str, np.ndarray],
                                        Dict[str, str]]:
    """(initializers by name, {initializer name: op type} for the weights
    of Conv and ConvTranspose nodes)."""
    from joshupscale_torch.export import onnx_minimal as om

    with open(onnx_path, "rb") as f:
        model = om.decode_model(f.read())
    return model["initializers"], conv_like(model["nodes"])


def conv_like(nodes) -> Dict[str, str]:
    out = {}
    for node in nodes:
        if node["op_type"] in ("Conv", "ConvTranspose"):
            for inp in node["inputs"][1:]:
                out[inp] = node["op_type"]
    return out


def _normalize(name: str) -> str:
    """tf2onnx initializer name -> dotted layer path (best effort)."""
    name = re.sub(r":\d+$", "", name)
    parts = [p for p in name.split("/") if p]
    drop = {"ReadVariableOp", "Conv2D", "BiasAdd", "FusedBatchNormV3",
            "conv2d_transpose", "MatMul", "model", "functional"}
    parts = [p for p in parts if p not in drop]
    return ".".join(parts) if parts else name


def main(onnx_path: str, npz_path: str) -> int:
    inits, convs = load_graph(onnx_path)
    out = {}
    for name, arr in inits.items():
        if name in convs and arr.ndim == 4:
            # Conv OIHW -> HWIO and ConvTranspose IOHW -> HWOI swap the
            # same axes; npz_to_onnx inverts both with (3, 2, 0, 1).
            arr = arr.transpose(2, 3, 1, 0)
        out[_normalize(name)] = arr
    np.savez(npz_path, **out)
    print(f"wrote {len(out)} arrays to {npz_path}")
    print("Load with joshupscale_torch.export.importer.load_params_npz "
          "(rename keys to your param tree paths as needed).")
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        print(__doc__)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2]))
