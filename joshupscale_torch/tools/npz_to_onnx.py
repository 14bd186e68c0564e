"""Patch an ONNX model's weights from a params ``.npz``.

Port of ``tools/npz_to_onnx.py``, the inverse of ``onnx_to_npz``: each
initializer of a donor graph is looked up in the npz under its
normalized name (``onnx_to_npz._normalize``), conv kernels transposed
back from HWIO to OIHW (and deconv kernels from ``(kh, kw, O, I)`` to
IOHW), its shape checked, and written back in the donor's dtype;
initializers with no match stay as they are and are reported.  Every
other byte of the donor is kept (``onnx_minimal.rewrite_initializers``),
so the result runs where the donor ran.  Round trip:
``onnx_to_npz(npz_to_onnx(donor, npz)) == npz``.  The port's own codec
does the work: the ``onnx`` package is not needed.

    python -m joshupscale_torch.tools.npz_to_onnx donor.onnx weights.npz \\
        out.onnx
"""

from __future__ import annotations

import sys

import numpy as np


def main(donor_path: str, npz_path: str, out_path: str) -> int:
    from joshupscale_torch.export import onnx_minimal as om
    from joshupscale_torch.tools.onnx_to_npz import _normalize, conv_like

    with np.load(npz_path) as data:
        weights = {k: data[k] for k in data.files}
    with open(donor_path, "rb") as f:
        donor = f.read()
    decoded = om.decode_model(donor)
    convs = conv_like(decoded["nodes"])
    missing, patched = [], []

    def patch(name, arr):
        key = _normalize(name)
        if key not in weights:
            missing.append(key)
            return None
        new = np.asarray(weights[key])
        if name in convs and new.ndim == 4:
            new = new.transpose(3, 2, 0, 1)
        if tuple(new.shape) != tuple(arr.shape):
            raise ValueError(f"{name} ({key}): npz shape {new.shape} != "
                             f"donor shape {arr.shape}")
        patched.append(name)
        return new.astype(arr.dtype)

    try:
        out = om.rewrite_initializers(donor, patch)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    with open(out_path, "wb") as f:
        f.write(out)
    print(f"patched {len(patched)}/{len(decoded['initializers'])} "
          f"initializers -> {out_path}")
    if missing:
        print("left untouched (no npz match): "
              + ", ".join(sorted(missing)[:10]))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 4:
        print(__doc__)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2], sys.argv[3]))
