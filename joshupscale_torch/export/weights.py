"""Carry parameters across the reference's flat ``.npz`` form.

The reference flattens its param trees to dotted paths
(``flow.block_3.conv_1.kernel`` ...; ``flatten_params`` /
``save_params_npz`` in ``joshupscale_tpu/export/importer.py``).
``from_flat_numpy`` rebuilds the nested dict and converts layouts to the
port's, and ``to_flat_numpy`` is its inverse:

- conv kernels HWIO ``(kh, kw, I, O)`` -> OHWI ``(O, kh, kw, I)``
  (see ``nn/layers.py``);
- deconv kernels ``(2, 2, O, I)`` (under ``conv_trans_*``) -> the 1x1
  product ``(I, 4*O)`` the s2d tail multiplies by;
- int8 ``kernel_q`` (``export/quantize.py``) the same ways, kept int8;
  its ``kernel_scale`` (per output channel of a conv, per input channel
  of a deconv: the reference's last axis either way) and ``act_scale``
  as float32;
- everything else (BN stats, biases, fade counters) as float32 tensors.

Numpy only: no JAX is needed to read or write a reference checkpoint.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from joshupscale_torch.nn.layers import deconv_matrix


def _convert(path: str, arr: np.ndarray) -> torch.Tensor:
    parts = path.split(".")
    leaf = parts[-1]
    layer = parts[-2] if len(parts) > 1 else ""
    arr = np.asarray(arr)
    if leaf in ("kernel", "kernel_q") and arr.ndim == 4:
        if layer.startswith("conv_trans"):
            arr = deconv_matrix(arr)
        else:
            arr = np.ascontiguousarray(arr.transpose(3, 0, 1, 2))
    dtype = np.int8 if leaf == "kernel_q" else np.float32
    return torch.from_numpy(np.array(arr, dtype=dtype))


def nest_flat(flat: Dict[str, np.ndarray]) -> dict:
    """Dotted-path dict -> nested dict, leaves as they are."""
    tree: dict = {}
    for path, arr in flat.items():
        node = tree
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return tree


def from_flat_numpy(flat: Dict[str, np.ndarray]):
    """Dotted-path numpy dict -> the port's nested param dict."""
    return nest_flat({path: _convert(path, arr)
                      for path, arr in flat.items()})


def _export(path: str, t: torch.Tensor) -> np.ndarray:
    parts = path.split(".")
    leaf = parts[-1]
    layer = parts[-2] if len(parts) > 1 else ""
    dtype = torch.int8 if leaf == "kernel_q" else torch.float32
    arr = t.detach().to("cpu", dtype).numpy()
    is_kernel = leaf in ("kernel", "kernel_q")
    if is_kernel and layer.startswith("conv_trans") and arr.ndim == 2:
        # (I, 4*O) with output channel (dy*2 + dx)*O + o -> (2, 2, O, I).
        in_ch, out4 = arr.shape
        arr = arr.reshape(in_ch, 2, 2, out4 // 4).transpose(1, 2, 3, 0)
    elif is_kernel and arr.ndim == 4:
        arr = arr.transpose(1, 2, 3, 0)  # OHWI -> HWIO
    # ascontiguousarray makes a 0-d array 1-d: scalars (fade counters)
    # keep the reference's shape ().
    return np.ascontiguousarray(arr) if arr.ndim else arr


def to_flat_numpy(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """The port's nested param dict -> the reference's dotted-path numpy
    dict, in the reference's layouts (the inverse of ``from_flat_numpy``)."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(to_flat_numpy(v, path))
        else:
            out[path] = _export(path, v)
    return out


def load_params_npz(path: str, prefix: str = ""):
    """Load a flat ``.npz`` (optionally its dotted ``prefix`` subtree)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    if prefix:
        dot = prefix + "."
        flat = {k[len(dot):]: v for k, v in flat.items()
                if k.startswith(dot)}
        if not flat:
            raise KeyError(f"no keys under prefix {prefix!r} in {path}")
    return from_flat_numpy(flat)
