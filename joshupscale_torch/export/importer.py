"""Weight import/export between the port's param trees and outside files.

Port of ``joshupscale_tpu/export/importer.py``.  The port's params are
the template everywhere: files hold the reference's flat dotted paths
and layouts (``export/weights.py`` converts both ways), so a file either
package writes loads in the other.

- npz: ``save_params_npz`` / ``load_params_npz`` (a dotted ``prefix``
  selects a subtree; given a ``template``, the file is read into it as
  the reference's ``unflatten_into`` reads), and ``load_trained_params``,
  which finds the prefix of any checkpoint layout itself
  (``detect_checkpoint_prefix``).  ``flatten_params`` /
  ``unflatten_into`` are the reference's tree <-> dotted-path pair on the
  port's trees (dicts, lists, tuples), in the reference's layouts.
- Keras h5 weight files: the reference trains Keras models and saves
  ``.h5`` weights (reference ``scripts/training/train_local.py:184-209``).
  ``load_keras_h5`` reads Keras 3 and legacy Keras 2 files,
  ``save_keras_h5`` writes the legacy layout.  Conv kernels are HWIO in
  the file (the reference's layout), ConvTranspose kernels
  ``(kh, kw, out, in)``.  ``h5py`` is imported only by these two.

ONNX import is gated as in the reference: ``load_onnx`` raises.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

import torch

from joshupscale_torch.export import weights
from joshupscale_torch.export.weights import (
    from_flat_numpy,
    nest_flat,
    to_flat_numpy,
)
from joshupscale_torch.models.registry import load_into

__all__ = [
    "detect_checkpoint_prefix",
    "flatten_params",
    "load_keras_h5",
    "load_onnx",
    "load_params_npz",
    "load_trained_params",
    "save_keras_h5",
    "save_params_npz",
    "unflatten_into",
]


def flatten_params(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A param tree (dicts, lists and tuples; ``_meta`` entries and
    None skipped) -> dotted paths to numpy arrays in the reference's
    layouts (``export/weights.py``): the reference's ``flatten_params``
    on the port's trees."""
    out = {}
    if isinstance(tree, dict):
        items = ((k, v) for k, v in tree.items() if k != "_meta")
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif tree is None:
        return out
    elif torch.is_tensor(tree):
        return {prefix: weights._export(prefix, tree)}
    else:
        return {prefix: np.asarray(tree)}
    for k, v in items:
        out.update(flatten_params(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def unflatten_into(template, flat: Dict[str, np.ndarray], prefix: str = ""):
    """A tree shaped like ``template`` (the port's layouts, dtypes and
    devices) from dotted paths in the reference's layouts: the
    reference's ``unflatten_into``.  Keys the template lacks are
    ignored; a missing one raises ``KeyError``, a wrong shape
    ``ValueError``."""
    def sub(k):
        return f"{prefix}.{k}" if prefix else str(k)

    if isinstance(template, dict):
        return {k: v if k == "_meta" else unflatten_into(v, flat, sub(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        items = [unflatten_into(v, flat, sub(i))
                 for i, v in enumerate(template)]
        if hasattr(template, "_fields"):
            return type(template)(*items)
        return type(template)(items)
    if template is None:
        return None
    if prefix not in flat:
        raise KeyError(f"Missing parameter in checkpoint: {prefix}")
    value = weights._convert(prefix, flat[prefix])
    if tuple(value.shape) != tuple(template.shape):
        raise ValueError(
            f"Shape mismatch for {prefix}: checkpoint "
            f"{np.shape(flat[prefix])} vs model {tuple(template.shape)}")
    return value.to(template.device, template.dtype)


def load_params_npz(path: str, template=None, prefix: str = ""):
    """A flat ``.npz`` (its dotted ``prefix`` subtree, if given) as the
    port's nested params; with ``template``, read into it
    (``unflatten_into``), as the reference's ``load_params_npz(path,
    template, prefix)`` does."""
    if template is None:
        return weights.load_params_npz(path, prefix)
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    if prefix:
        dot = prefix + "."
        flat = {k[len(dot):]: v for k, v in flat.items()
                if k.startswith(dot)}
        if not flat:
            raise KeyError(f"no keys under prefix {prefix!r} in {path}")
    return unflatten_into(template, flat)


def save_params_npz(path: str, params) -> None:
    """The port's params as the reference's flat ``.npz``."""
    np.savez(path, **to_flat_numpy(params))


def detect_checkpoint_prefix(path: str) -> str:
    """Prefix that maps a checkpoint onto an INFERENCE param tree.

    ``fit()`` saves train STATES flattened whole: a GANTrainState's
    generator subtree lives under ``gen_params.`` ({flow, generator}),
    a TrainState's under ``params.``.  A raw ``save_params_npz`` export
    needs no prefix.
    """
    with np.load(path) as data:
        keys = list(data.files)
    for prefix in ("gen_params.", "params."):
        if any(k.startswith(prefix + "generator.")
               or k.startswith(prefix + "flow.") for k in keys):
            return prefix[:-1]
    return ""


def load_trained_params(path: str, template):
    """``template``'s params from ANY checkpoint layout, auto-detected:
    a raw ``save_params_npz`` export, a ``fit()`` FRVSR TrainState
    checkpoint (``params.`` prefix) or a GANTrainState checkpoint
    (``gen_params.``)."""
    prefix = detect_checkpoint_prefix(path)
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    if prefix:
        dot = prefix + "."
        flat = {k[len(dot):]: v for k, v in flat.items()
                if k.startswith(dot)}
    return unflatten_into(template, flat)


# ---------------------------------------------------------------------------
# Keras h5


# Keras save order of a layer's weights, per layer kind.
_KERAS_WEIGHT_ORDER = {
    "conv": ("kernel", "bias"),
    "bn": ("gamma", "beta", "moving_mean", "moving_variance"),
    "dense": ("kernel", "bias"),
    # Fade-in layer state (reference FadeInLayer save_own_variables
    # persists the counter; the period is layer CONFIG, kept by the
    # load-side template).
    "fade": ("counter",),
}


def _layer_kind(subtree: dict):
    keys = set(subtree)
    if "gamma" in keys:
        return "bn"
    if "kernel" in keys:
        return "conv"
    if "counter" in keys:
        return "fade"
    return None


def save_keras_h5(path: str, params, scope: str = "") -> None:
    """Write the port's params as a legacy Keras ``.h5`` weights file.

    The exit door back into the reference ecosystem: layers are written
    in the named legacy layout (``<layer>/<layer>/<var>:0`` +
    ``layer_names``/``weight_names`` attrs) that both Keras 2
    ``load_weights(by_name=True)`` and :func:`load_keras_h5` read, with
    the reference's layouts (HWIO conv kernels).  ``scope`` prefixes
    layer names (e.g. ``generator_``).
    """
    import h5py

    layers: Dict[str, Dict[str, np.ndarray]] = {}

    def walk(subtree, prefix):
        if not isinstance(subtree, dict):
            return
        kind = _layer_kind(subtree)
        if kind is None:
            for k, v in subtree.items():
                walk(v, f"{prefix}.{k}" if prefix else str(k))
            return
        layer_name = scope + prefix.replace(".", "_")
        order = [k for k in _KERAS_WEIGHT_ORDER[kind] if k in subtree]
        layers[layer_name] = {key: subtree[key] for key in order}

    walk(nest_flat(to_flat_numpy(params)), "")
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = [name.encode() for name in layers]
        f.attrs["backend"] = b"tensorflow"
        for name, weights in layers.items():
            g = f.create_group(name)
            g.attrs["weight_names"] = [
                f"{name}/{var}:0".encode() for var in weights
            ]
            inner = g.create_group(name)
            for var, arr in weights.items():
                inner.create_dataset(f"{var}:0", data=arr)


def _read_h5_layers(path: str):
    """``(positional, named)``: Keras 3 layers as lists of arrays in the
    layer's canonical order, legacy layers as {varname: array}, both
    keyed by the submodel-qualified layer name."""
    import h5py

    named: Dict[str, Dict[str, np.ndarray]] = {}
    positional: Dict[str, list] = {}

    def _dec(x):
        return x.decode() if isinstance(x, bytes) else str(x)

    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if (isinstance(obj, h5py.Group)
                    and name.split("/")[-1] == "vars"):
                lname = obj.attrs.get("name")
                if lname is None:
                    return
                arrs = [np.asarray(obj[k])
                        for k in sorted(obj.keys(), key=lambda s: int(s))]
                if not arrs:
                    return
                # Keras 3 nests submodels: the path is
                # layers/<g>(/layers/<g>)*/vars and each enclosing <g>
                # group's own "vars" carries the TRUE submodel name.
                comps = name.split("/")
                scopes = []
                for depth in range(1, (len(comps) - 1) // 2):
                    vg = f.get("/".join(comps[:2 * depth]) + "/vars")
                    nm = vg.attrs.get("name") if vg is not None else None
                    scopes.append(_dec(nm) if nm is not None
                                  else comps[2 * depth - 1])
                positional["_".join(scopes + [_dec(lname)])] = arrs
            elif hasattr(obj, "shape") and ":" in name.rsplit("/", 1)[-1]:
                parts = name.replace(":0", "").split("/")
                var = parts[-1]
                comps = parts[:-1]
                if comps and comps[0] == "model_weights":
                    comps = comps[1:]
                # Legacy layout repeats the layer group name
                # (<layer>/<layer>/<var>:0); nested submodels prepend
                # their group.  Collapse adjacent duplicates so flat
                # files key as before and nested ones qualify.
                qual = [p for i, p in enumerate(comps)
                        if i == 0 or p != comps[i - 1]]
                named.setdefault("_".join(qual), {})[var] = np.asarray(obj)

        f.visititems(visit)
    return positional, named


def load_keras_h5(path: str, template, scope: str = ""):
    """Load a Keras ``.h5`` weights file into ``template``'s structure.

    Supports both formats the reference ecosystem produces:

    - Keras 3: ``layers/<auto>/vars/<i>`` datasets; the TRUE layer name
      lives in the ``vars`` group's ``name`` attribute, and weights are
      positional in the layer's canonical order (conv: kernel[, bias];
      BN: gamma, beta, moving_mean, moving_variance).
    - Legacy Keras 2 (what the reference's train_local.py wrote):
      ``model_weights/<layer>/<layer>/<var>:0`` with named variables.

    Layer names map to tree paths: ``block_3_bn_2`` -> ``block_3.bn_2``;
    layers of composed models are qualified by their enclosing
    submodels (``flow_conv_1`` / ``generator_conv_1``).  ``scope``
    strips a leading prefix (e.g. ``generator_``) from h5 layer names
    first.  A fade block's ``period`` is layer config: the template's
    stands.
    """
    positional, named = _read_h5_layers(path)

    def lookup(layer_name: str):
        candidates = [layer_name]
        if scope:
            candidates.insert(0, f"{scope}{layer_name}")
        for cand in candidates:
            if cand in positional:
                return ("pos", positional[cand])
            if cand in named:
                return ("named", named[cand])
        return None

    unmatched = []

    def fill(subtree, prefix):
        if not isinstance(subtree, dict):
            return subtree
        kind = _layer_kind(subtree)
        if kind is None:
            return {k: fill(v, f"{prefix}.{k}" if prefix else str(k))
                    for k, v in subtree.items()}
        layer_name = prefix.replace(".", "_")
        found = lookup(layer_name)
        if found is None:
            unmatched.append(layer_name)
            return subtree
        how, data = found
        out = dict(subtree)
        persisted = _KERAS_WEIGHT_ORDER[kind]
        if how == "named":
            for key in subtree:
                if key not in persisted:
                    continue
                if key not in data:
                    unmatched.append(f"{layer_name}/{key}")
                    continue
                out[key] = data[key]
        else:
            order = [k for k in persisted if k in subtree]
            if len(order) != len(data):
                raise KeyError(
                    f"Layer {layer_name}: checkpoint has {len(data)} "
                    f"weights, model expects {len(order)} ({order})")
            out.update(zip(order, data))
        for key in subtree:
            if tuple(np.shape(out[key])) != tuple(np.shape(subtree[key])):
                raise ValueError(
                    f"Shape mismatch at {layer_name}/{key}: checkpoint "
                    f"{np.shape(out[key])} vs model "
                    f"{np.shape(subtree[key])}")
        return out

    result = fill(nest_flat(to_flat_numpy(template)), "")
    if unmatched:
        raise KeyError(
            f"Keras h5 import left {len(unmatched)} layers unmatched "
            f"(first: {', '.join(sorted(unmatched)[:8])})")

    def flatten(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            p = f"{prefix}.{k}" if prefix else k
            out.update(flatten(v, p) if isinstance(v, dict) else {p: v})
        return out

    return load_into(template, from_flat_numpy(flatten(result)))


def load_onnx(path: str, template):
    raise NotImplementedError(
        "ONNX import requires the 'onnx' package, which the port does not "
        "use. Convert the model to npz with tools/onnx_to_npz.py on a "
        "machine with onnx installed, then load it with "
        "load_params_npz().")
