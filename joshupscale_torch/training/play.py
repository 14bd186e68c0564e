"""Play prediction and GIF summaries of a training run.

Port of ``joshupscale_tpu/training/play.py``: run the inference model
over a 10-frame clip forward then 8 frames back (ping-pong playback),
build side-by-side strips (nearest-upscaled input | generated | target)
on the host, and write them as GIFs each epoch.  The model runs its
serving form: the trained raw params are prepared (``prepare_params``:
batch norm folded, K1's res-block form) on every call, so on the card
the prediction's res blocks go through K1 in the model's compute dtype.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from joshupscale_torch.ops.resize import upscale_nearest
from joshupscale_torch.training.frvsr import preprocess_batch

# The playback runs clip frames 0..9 then 8..1.
PLAY_FRAMES = 10


def predict_sequence(model, params, inputs: torch.Tensor,
                     targets: Optional[torch.Tensor] = None
                     ) -> Dict[str, torch.Tensor]:
    """Ping-pong playback of frames 0..9 then 8..1 (18 outputs).

    ``params``: the model's raw params ({"flow", "generator"}), prepared
    here on ``inputs``' device; inputs (N, 10, H, W, 3) floats in [-0.5,
    0.5] (the model's ``skip_processing`` form).  Returns
    ``gen_outputs`` (N, 18, 4H, 4W, 3) and, given ``targets``,
    ``upscaled`` (N, 10, 4H, 4W, 3) and ``pre_warp_frames`` (N, 16, ...:
    the warped state of outputs 2..17).
    """
    n, _, h, w, _ = inputs.shape
    with torch.no_grad():
        prepared = model.prepare_params(params, inputs.device)
        state = model.init_state(n, dtype=inputs.dtype,
                                 device=inputs.device)
        gen_outputs, pre_warps = [], []
        for i in (list(range(PLAY_FRAMES))
                  + list(range(PLAY_FRAMES - 2, 0, -1))):
            outputs, state = model.apply(prepared, inputs[:, i], state)
            gen_outputs.append(outputs["output_denorm"])
            if i > 0:
                pre_warps.append(outputs["pre_warp"])
        result = {"gen_outputs": torch.stack(gen_outputs, dim=1)}
        if targets is not None:
            ups = upscale_nearest(inputs.reshape(-1, h, w, 3).float(), 4)
            result["upscaled"] = ups.reshape(n, 10, h * 4, w * 4, 3)
            result["pre_warp_frames"] = torch.stack(pre_warps[1:], dim=1)
    return result


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def build_strips(result, targets) -> Dict[str, np.ndarray]:
    """The side-by-side strips (input | generated | target), as numpy
    arrays on the host: ``comparison`` (N, 18, 4H, 12W, 3) and
    ``pre_warp`` (N, 16, ...), with the generated frames."""
    gen = _host(result["gen_outputs"])
    ups = _host(result["upscaled"])
    tgt = _host(targets)
    ups_pp = np.concatenate([ups, ups[:, 8:0:-1]], axis=1)
    tgt_pp = np.concatenate([tgt, tgt[:, 8:0:-1]], axis=1)
    warps = _host(result["pre_warp_frames"])
    return {
        "gen_outputs": gen,
        "comparison": np.concatenate([ups_pp, gen, tgt_pp], axis=3),
        "pre_warp": np.concatenate([ups_pp[:, 2:], warps, tgt_pp[:, 2:]],
                                   axis=3),
    }


def to_uint8(frames: np.ndarray) -> np.ndarray:
    """[-0.5, 0.5] float frames -> uint8 (clipped, rounded)."""
    x = np.clip(np.asarray(frames, np.float32) + 0.5, 0.0, 1.0)
    return (x * 255.0 + 0.5).astype(np.uint8)


def save_gif(path: str, frames: np.ndarray, fps: int = 10) -> None:
    """Encode (T, H, W, 3) BGR uint8 frames as an animated GIF (PIL)."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imgs = [Image.fromarray(f[:, :, ::-1]) for f in frames]  # BGR -> RGB
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)


class PlayCallback:
    """Epoch callback: predict the play batch (every ``interval``
    epochs) and write the comparison GIFs of its first 4 clips to
    ``out_dir`` (and their first frames to ``tb_logger``)."""

    def __init__(self, model, play_batch: Dict[str, Any], out_dir: str,
                 interval: int = 1, tb_logger=None, device=None):
        from joshupscale_torch import resolve_device

        dev = resolve_device(device)
        self.inputs = preprocess_batch(
            torch.as_tensor(np.asarray(play_batch["input"])).to(dev))
        self.targets = preprocess_batch(
            torch.as_tensor(np.asarray(play_batch["target"])).to(dev))
        # The play clip is a training crop: the model's frame size sizes
        # its state, so the model is re-dimensioned to the clip.
        h, w = self.inputs.shape[2], self.inputs.shape[3]
        if (model.frame_height, model.frame_width) != (h, w):
            model = dataclasses.replace(model, frame_height=h,
                                        frame_width=w)
        self.model = model
        self.out_dir = out_dir
        self.interval = max(int(interval), 1)
        self.tb_logger = tb_logger

    def params_of(self, state):
        """The inference params of a train state: a FRVSR state's params,
        or a GAN state's generator group."""
        params = getattr(state, "params", None)
        if params is None:
            params = state.gen_params
        return {"flow": params["flow"], "generator": params["generator"]}

    def predict(self, state) -> Dict[str, np.ndarray]:
        """The play batch's strips under ``state``'s params."""
        return build_strips(predict_sequence(self.model,
                                             self.params_of(state),
                                             self.inputs, self.targets),
                            self.targets)

    def __call__(self, epoch: int, state, entry: Dict[str, Any]) -> None:
        if epoch % self.interval:
            return
        comp = to_uint8(self.predict(state)["comparison"])
        for i in range(min(comp.shape[0], 4)):
            save_gif(os.path.join(self.out_dir,
                                  f"play_e{epoch:04d}_{i}.gif"), comp[i])
        if self.tb_logger is not None:
            # The first frame of each clip, BGR -> RGB.
            self.tb_logger.images("play/comparison",
                                  comp[:4, 0, :, :, ::-1], epoch)
