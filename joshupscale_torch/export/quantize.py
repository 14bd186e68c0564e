"""Int8 quantization for serving.

Port of ``joshupscale_tpu/export/quantize.py`` on the port's param trees
and layouts (``nn/layers.py``):

- Weights: per-channel symmetric int8 with float32 scales
  (``quantize_kernel_int8``), for every conv and deconv kernel of at
  least ``min_elements`` weights (``quantize_params_int8``).
- Activations: a dynamic per-tensor scale computed on the device from
  each conv input's absmax, or a static ``act_scale`` from calibrated
  ranges (``calibrate`` + ``quantize_params_int8(ranges=...)``).
- Convs run the int8 x int8 -> int32 product, then dequantize by
  ``act_scale * kernel_scale`` (``nn.layers.conv2d_int8``); deconvs
  dequantize their weights.

Usage::

    qparams = quantize_params_int8(params)     # or ranges=calibrate(...)
    engine = Engine(model, qparams)

``quantize_kernel_int8`` and ``kl_threshold`` are the reference's numpy
code; the port keeps its own copies.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from joshupscale_torch import DeviceLike, resolve_device
from joshupscale_torch.nn.layers import recording


def quantize_kernel_int8(kernel):
    """Symmetric int8 quantization per leading-axis slice: an OHWI conv
    kernel per output channel, a deconv's (I, 4*O) product per input row
    (the reference's last axis of either's kernel).

    Returns (int8 kernel, float32 scale of shape (kernel.shape[0],)),
    equal to the reference's on the same kernel in its layout.
    """
    k = np.asarray(kernel, np.float32)
    absmax = np.abs(k).max(axis=tuple(range(1, k.ndim)))
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(k / scale.reshape((-1,) + (1,) * (k.ndim - 1))),
                -127, 127).astype(np.int8)
    return q, scale


def _is_kernel(path: str, params) -> bool:
    """A conv's OHWI kernel, or a deconv's (I, 4*O) product."""
    kernel = params.get("kernel")
    if kernel is None:
        return False
    if path.split(".")[-1].startswith("conv_trans"):
        return kernel.ndim == 2
    return kernel.ndim == 4


def quantize_params_int8(params, min_elements: int = 4096,
                         ranges: Optional[Dict[str, float]] = None,
                         _path: str = ""):
    """Quantize every conv and deconv kernel in a param tree to int8.

    Layers with fewer than ``min_elements`` kernel weights stay float.
    ``ranges`` maps dotted layer paths (``calibrate``'s keys) to
    calibrated activation absmax values; layers present get a static
    ``act_scale = range / 127`` instead of the dynamic one.
    """
    if not isinstance(params, dict):
        return params
    if _is_kernel(_path, params):
        kernel = params["kernel"]
        if kernel.numel() < min_elements:
            return dict(params)
        q, scale = quantize_kernel_int8(kernel.detach().cpu().numpy())
        out = {k: v for k, v in params.items() if k != "kernel"}
        out["kernel_q"] = torch.from_numpy(q).to(kernel.device)
        out["kernel_scale"] = torch.from_numpy(scale).to(kernel.device)
        if ranges and _path in ranges:
            out["act_scale"] = torch.tensor(
                np.float32(ranges[_path] / 127.0), device=kernel.device)
        return out
    return {k: quantize_params_int8(v, min_elements, ranges,
                                    f"{_path}.{k}" if _path else str(k))
            for k, v in params.items()}


def _sweep(model, params, frames: torch.Tensor, record, device) -> None:
    """Stream ``frames`` (T, N, H, W, 3) through the recurrent model on
    its calibration route (``prepare_params(calibration=True)``: batch
    norm unfolded, as the reference's sweep runs it, and each float conv
    labelled with its dotted path), calling ``record(path, x)`` with
    each labelled conv's input."""
    prepared = model.prepare_params(params, device, calibration=True)
    state = model.init_state(frames.shape[1], device=device)
    with torch.inference_mode(), recording(record):
        for t in range(frames.shape[0]):
            _, state = model.apply(prepared, frames[t], state)


def kl_threshold(hist: np.ndarray, num_quantized_bins: int = 128) -> int:
    """Optimal clip bin index by KL divergence (TensorRT Entropy rule).

    ``hist`` is a histogram of |activation| over uniform bins spanning
    [0, absmax].  For each candidate clip point ``i`` the reference
    distribution P is ``hist[:i]`` with the outlier tail folded into
    its last bin, and the candidate Q is P collapsed to
    ``num_quantized_bins`` int8 levels and re-expanded over P's nonzero
    support.  Returns the ``i`` minimizing KL(P||Q).
    """
    hist = np.asarray(hist, np.float64)
    n = len(hist)
    if n <= num_quantized_bins or hist.sum() == 0:
        return n
    eps = 1e-4
    best_i, best_kl = n, np.inf
    for i in range(num_quantized_bins, n + 1):
        p = hist[:i].copy()
        p[i - 1] += hist[i:].sum()
        nonzero = hist[:i] > 0
        # Collapse the first i bins onto the int8 levels, then expand
        # each level's mass uniformly over its nonzero source bins.
        idx = np.arange(i) * num_quantized_bins // i
        level_mass = np.bincount(idx, weights=hist[:i],
                                 minlength=num_quantized_bins)
        level_nnz = np.bincount(idx, weights=nonzero.astype(np.float64),
                                minlength=num_quantized_bins)
        with np.errstate(divide="ignore", invalid="ignore"):
            per_bin = np.where(level_nnz > 0, level_mass / level_nnz, 0.0)
        q = np.where(nonzero, per_bin[idx], 0.0)
        # Smooth (the MXNet/TensorRT recipe): move eps mass onto empty
        # bins so KL stays finite, normalize, accumulate divergence.
        p_is_zero = p == 0
        q_is_zero = q == 0
        if (~q_is_zero).sum() == 0:
            continue
        p_s = p + eps * p_is_zero - (eps * p_is_zero.sum()
                                     / max((~p_is_zero).sum(), 1)
                                     ) * (~p_is_zero)
        q_s = q + eps * q_is_zero - (eps * q_is_zero.sum()
                                     / max((~q_is_zero).sum(), 1)
                                     ) * (~q_is_zero)
        p_s = np.clip(p_s, 1e-12, None)
        q_s = np.clip(q_s, 1e-12, None)
        p_s /= p_s.sum()
        q_s /= q_s.sum()
        kl = float(np.sum(p_s * np.log(p_s / q_s)))
        if kl < best_kl:
            best_kl, best_i = kl, i
    return best_i


def histogram_edges(top: float, bins: int) -> np.ndarray:
    """The reference's bin edges over [0, top]: ``jnp.histogram``'s
    float32 ``linspace`` as XLA compiles it, ``(top * float32(1 /
    bins)) * i`` (the division by a constant becomes a product with the
    reciprocal, reassociated), the last edge ``top`` itself."""
    step = np.float32(top) * (np.float32(1.0) / np.float32(bins))
    return np.append(step * np.arange(bins, dtype=np.float32),
                     np.float32(top))


def abs_histogram(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Counts of |x| in the bins between float32 ``edges``, on x's
    device, binned as ``jnp.histogram`` bins: bin i holds
    ``edges[i] <= v < edges[i + 1]``, and the last bin is closed."""
    a = x.abs().float().reshape(-1)
    bins = edges.numel() - 1
    idx = torch.searchsorted(edges, a, right=True)
    idx = torch.where(a == edges[-1], bins, idx)
    return torch.bincount(idx, minlength=bins + 1)[1:]


def calibrate(model, params, frames, percentile: float = 100.0,
              method: Optional[str] = None, bins: int = 2048,
              device: DeviceLike = None) -> Dict[str, float]:
    """Calibrate per-conv-INPUT activation ranges over ``frames``
    ((T, N, H, W, 3) u8), on ``device`` (the card unless the caller
    names the CPU).

    The reference's three calibrators:

    - ``minmax`` (default): absmax over every conv call.
    - ``percentile``: per-call absmax percentile (``percentile < 100``
      implies this method).
    - ``entropy``: a second sweep accumulates an |x| histogram per layer
      on the device (``abs_histogram``) and ``kl_threshold`` picks the
      clip minimizing KL(P||Q) against the 128-level int8 grid.

    Returns {dotted_conv_path: range} for
    ``quantize_params_int8(ranges=...)``: the reference's keys, which
    name the convs its sweep sees (every float conv, and the deconvs of
    the pixel-form tail).
    """
    if method is None:
        method = "percentile" if percentile < 100.0 else "minmax"
    if method not in ("minmax", "percentile", "entropy"):
        raise ValueError(f"Unknown calibration method: {method}")
    device = resolve_device(device)
    if not isinstance(frames, torch.Tensor):
        frames = torch.from_numpy(np.asarray(frames))
    frames = frames.to(device)

    stats: Dict[str, list] = {}

    def record_absmax(path, x):
        # Kept on the device; read once after the sweep.
        stats.setdefault(path, []).append(x.abs().amax().float())

    _sweep(model, params, frames, record_absmax, device)
    calls = {p: torch.stack(v).cpu().numpy().astype(np.float64)
             for p, v in stats.items()}
    absmax = {p: float(np.max(v)) for p, v in calls.items()}
    if method == "minmax":
        return absmax
    if method == "percentile":
        return {p: float(np.percentile(v, percentile))
                for p, v in calls.items()}

    edges = {p: torch.from_numpy(histogram_edges(top, bins)).to(device)
             for p, top in absmax.items() if top > 0}
    hists: Dict[str, torch.Tensor] = {}

    def record_hist(path, x):
        if path not in edges:
            return
        h = abs_histogram(x, edges[path])
        hists[path] = h if path not in hists else hists[path] + h

    _sweep(model, params, frames, record_hist, device)
    out = {}
    for path, top in absmax.items():
        hist = hists.get(path)
        if hist is None:
            out[path] = top
            continue
        i = kl_threshold(hist.cpu().numpy().astype(np.float64))
        out[path] = (i + 0.5) * (top / bins)
    return out
