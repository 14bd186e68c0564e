"""Notebook display helpers for datasets and model outputs.

The port's own copy of ``joshupscale_tpu/utils/display.py`` (the
reference package cannot be imported without jax), the analog of the
reference training scripts' ``utils.display_data``: a matplotlib grid of
a dataset's input sequences and targets.  It works on the port's
iterable datasets (``joshupscale_torch.data.create_dataset`` elements
are dicts of numpy arrays).

matplotlib is imported only inside the drawing functions, so the module
imports without it; pass ``save_path`` for headless use, otherwise
``plt.show()`` renders inline in a notebook.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Sequence

import numpy as np

__all__ = ["to_display", "display_data", "display_comparison"]


def to_display(img: np.ndarray, bgr: bool = True) -> np.ndarray:
    """A pipeline image as displayable RGB float32 in [0, 1].

    Takes the pipeline's two conventions: normalized float in
    [-0.5, 0.5] (after ``NormalizeOp``; BGR channel order by default, as
    the decode ops emit it) and uint8.
    """
    img = np.asarray(img)
    if img.dtype == np.uint8:
        out = img.astype(np.float32) / 255.0
    else:
        out = np.clip(img.astype(np.float32) + 0.5, 0.0, 1.0)
    if bgr and out.ndim >= 3 and out.shape[-1] == 3:
        out = out[..., ::-1]
    return out


def _take_elements(dataset: Iterable[Dict[str, Any]],
                   num_img: int) -> Sequence[Dict[str, np.ndarray]]:
    """The first ``num_img`` unbatched elements of an iterable dataset."""
    out = []
    for elem in dataset:
        arrs = {k: np.asarray(v) for k, v in elem.items()}
        seq = arrs.get("input")
        if seq is not None and seq.ndim == 5:  # batched: unbatch
            for b in range(seq.shape[0]):
                out.append({k: v[b] for k, v in arrs.items()})
                if len(out) >= num_img:
                    return out
        else:
            out.append(arrs)
        if len(out) >= num_img:
            return out
    return out


def _pyplot(save_path: Optional[str]):
    import matplotlib

    if save_path is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _finish(plt, fig, save_path: Optional[str]) -> None:
    if save_path is not None:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    else:  # pragma: no cover - interactive
        plt.show()


def display_data(dataset: Iterable[Dict[str, Any]], num_img: int,
                 bgr: bool = True,
                 save_path: Optional[str] = None) -> None:
    """A grid of dataset samples: each element's input sequence over its
    targets.

    Takes both element forms of the pipeline: paired sequences
    (``input`` / ``target`` both (T, H, W, 3)) and the FRVSR-single
    window form (``input`` (T, H, W, 3) with single ``last`` and
    ``target`` frames, drawn side by side in the second row).
    """
    plt = _pyplot(save_path)
    elems = _take_elements(dataset, num_img)
    if not elems:
        raise ValueError("dataset yielded no elements")
    seq_len = elems[0]["input"].shape[0]
    # The window form needs two cells in its second row (last | target).
    cols = max(seq_len, 2) if "last" in elems[0] else seq_len
    fig = plt.figure(figsize=(2 * cols, 4 * len(elems)))
    rows = 2 * len(elems)

    def cell(index, img):
        ax = fig.add_subplot(rows, cols, index)
        ax.axis("off")
        ax.imshow(to_display(img, bgr))

    for ind, elem in enumerate(elems):
        base = ind * 2 * cols
        for i in range(seq_len):
            cell(base + 1 + i, elem["input"][i])
        if "last" in elem:
            cell(base + 2 * cols - 1, elem["last"])
            cell(base + 2 * cols, elem["target"])
        else:
            for i in range(seq_len):
                cell(base + cols + 1 + i, elem["target"][i])
    _finish(plt, fig, save_path)


def display_comparison(lr: np.ndarray, out: np.ndarray, hr: np.ndarray,
                       bgr: bool = False, upscale: int = 4,
                       save_path: Optional[str] = None) -> None:
    """Side by side: the LR frame upscaled by pixel repetition, the
    model's output and the ground truth."""
    plt = _pyplot(save_path)
    lr_up = np.repeat(np.repeat(np.asarray(lr), upscale, 0), upscale, 1)
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, img, title in zip(axes, (lr_up, out, hr),
                              (f"LR nearest x{upscale}", "model",
                               "ground truth")):
        ax.axis("off")
        ax.set_title(title)
        ax.imshow(to_display(img, bgr))
    _finish(plt, fig, save_path)
