"""Convert Keras VGG19 ImageNet weights (.h5) to the npz the perceptual
loss loads (``block{B}_conv{I}.kernel`` / ``.bias``).

Port of ``tools/keras_vgg_to_npz.py``.  The reference's perceptual loss
uses Keras-applications VGG19 ImageNet weights
(``VGG19(weights="imagenet", include_top=False)``); the port's VGG
(``models/vgg.py``, the registry's ``vgg`` entry with ``weights:``)
takes them as a plain npz:

    python -m joshupscale_torch.tools.keras_vgg_to_npz \\
        vgg19_weights_tf_dim_ordering_tf_kernels_notop.h5 vgg19.npz

Both h5 layouts are read: the legacy Keras-applications topology file
(per-layer groups, ``<layer>/<layer>/kernel:0`` datasets) and Keras 3
``.weights.h5`` (``.../block{B}_conv{I}/vars/{0,1}``).  Host only:
numpy and ``h5py``, imported when a file is read.
"""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np

# VGG19's conv layers: name -> (in channels, out channels).
_CHANNELS = {}
_in = 3
for _block, _n, _ch in [(1, 2, 64), (2, 2, 128), (3, 4, 256),
                        (4, 4, 512), (5, 4, 512)]:
    for _i in range(1, _n + 1):
        _CHANNELS[f"block{_block}_conv{_i}"] = (_in, _ch)
        _in = _ch

_LAYER_RE = re.compile(r"block\d+_conv\d+")


def extract_vgg19(h5_path: str):
    """``{layer: {"kernel": ..., "bias": ...}}`` from the h5 file, each
    checked against VGG19's shapes."""
    import h5py

    found = {}

    def visit(name, obj):
        if not isinstance(obj, h5py.Dataset):
            return
        m = _LAYER_RE.search(name)
        if not m:
            return
        arr = np.asarray(obj)
        slot = found.setdefault(m.group(0), {})
        if arr.ndim == 4:
            slot["kernel"] = arr
        elif arr.ndim == 1:
            slot["bias"] = arr

    with h5py.File(h5_path, "r") as f:
        f.visititems(visit)

    missing = sorted(set(_CHANNELS) - set(found))
    if missing:
        raise SystemExit(f"h5 file is missing VGG19 conv layers: {missing}; "
                         "is this a VGG19 weights file?")
    for layer, (cin, cout) in _CHANNELS.items():
        slot = found[layer]
        if "kernel" not in slot or "bias" not in slot:
            raise SystemExit(f"{layer}: kernel/bias dataset not found")
        k, b = slot["kernel"], slot["bias"]
        if k.shape != (3, 3, cin, cout):
            raise SystemExit(f"{layer}: kernel shape {k.shape}, expected "
                             f"(3, 3, {cin}, {cout})")
        if b.shape != (cout,):
            raise SystemExit(f"{layer}: bias shape {b.shape}, expected "
                             f"({cout},)")
    return found


def convert(h5_path: str, npz_path: str) -> None:
    found = extract_vgg19(h5_path)
    flat = {}
    for layer in _CHANNELS:
        flat[f"{layer}.kernel"] = found[layer]["kernel"].astype(np.float32)
        flat[f"{layer}.bias"] = found[layer]["bias"].astype(np.float32)
    np.savez(npz_path, **flat)
    n_params = sum(v.size for v in flat.values())
    print(f"wrote {npz_path}: {len(flat)} arrays, "
          f"{n_params / 1e6:.1f}M parameters")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("h5_path", help="Keras VGG19 weights .h5")
    ap.add_argument("npz_path", help="output .npz")
    args = ap.parse_args(argv)
    convert(args.h5_path, args.npz_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
