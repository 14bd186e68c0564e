"""The reference ONNX runner loop over the exported deployment graph.

Port of ``joshupscale_tpu/export/onnx_interp.py``.  The reference runs
its exported ``.onnx`` engines with onnxruntime
(``scripts/inference/onnx/inference.py:63-94``: feed ``cur_frame``,
carry ``pre_gen``/``last_frame_i`` state outputs back into the next
call).  Neither ``onnx`` nor ``onnxruntime`` is used here: the graph
emitted by :mod:`joshupscale_torch.export.onnx_export` is executed op
by op through torch by :func:`onnx_torch.run_graph_torch`.

It is a *verification runtime*, not a serving path (serving is
``runtime/engine.py``): it checks the exported artifact's semantics
end to end -- the analog of running the reference's runner on the
exported engine before shipping it to TensorRT.  ``OnnxClipRunner``
runs on the CUDA device unless given another executor; ``run_graph``
is the CPU executor, under the JAX module's name.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from joshupscale_torch.export import onnx_minimal as om
from joshupscale_torch.export.onnx_torch import (model_float_dtype,
                                                 run_graph_torch)


def run_graph(model: Dict[str, Any],
              feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Execute a decoded model (see ``onnx_minimal.decode_model``) on a
    dict of input arrays on the CPU; returns the graph outputs by name
    (``run_graph_torch`` on the CPU)."""
    return run_graph_torch(model, feeds, device="cpu")


class OnnxClipRunner:
    """The reference ONNX runner loop (onnx/inference.py:63-94) over an
    exported graph: u8 BGR frames in, u8 BGR 4x frames out, with the
    recurrent state (``pre_gen`` + ``last_frame_i``) fed back between
    frames and zero-initialized at construction/reset."""

    def __init__(self, path_or_model, height: int, width: int,
                 num_flow_frames: int = 4, stateless: bool = False,
                 executor=None) -> None:
        """``stateless=True`` drives a remove_flow graph (single frame
        in, single frame out, no recurrent feeds).  ``executor``
        defaults to ``run_graph_torch`` on the CUDA device; pass
        ``run_graph`` (or ``functools.partial(run_graph_torch,
        device=...)``) to run the loop elsewhere."""
        if isinstance(path_or_model, (str, bytes)):
            with open(path_or_model, "rb") as f:
                path_or_model = om.decode_model(f.read())
        self.model = path_or_model
        self._run = executor if executor is not None else run_graph_torch
        self.h, self.w = height, width
        self.num_last = 0 if stateless else num_flow_frames - 1
        self.stateless = stateless
        self.dtype = model_float_dtype(self.model)
        self.reset()

    def reset(self) -> None:
        if self.stateless:
            self.feeds: Dict[str, np.ndarray] = {}
            return
        # State shapes come from the graph's own input value infos --
        # flow_pad_factor graphs carry last_frame_i at the PADDED size.
        shapes = {vi["name"]: vi["shape"] for vi in self.model["inputs"]}
        self.feeds = {
            "pre_gen": np.zeros(shapes.get(
                "pre_gen", (1, 3, 4 * self.h, 4 * self.w)), self.dtype),
            **{f"last_frame_{i}": np.zeros(shapes.get(
                f"last_frame_{i}", (1, 3, self.h, self.w)), self.dtype)
               for i in range(self.num_last)},
        }

    def process(self, frame: np.ndarray) -> np.ndarray:
        """One recurrent step: (H, W, 3) u8 -> (4H, 4W, 3) u8."""
        self.feeds["cur_frame"] = frame[None].astype(self.dtype)
        outs = self._run(self.model, self.feeds)
        if not self.stateless:
            self.feeds["pre_gen"] = outs["output_raw"]
            for i in range(self.num_last):
                self.feeds[f"last_frame_{i}"] = outs[f"out_frame_{i}"]
        return np.clip(outs["output"], 0, 255).astype(np.uint8)[0]
