"""FRVSR pretraining: recurrent content + warp L2 over a T-frame unroll.

Port of ``joshupscale_tpu/training/frvsr.py``.  The flow net runs once
over all T-1 adjacent frame pairs, batched; the generator runs the
recurrence frame by frame with the previous HR output warped by the
flow as its second input, each step under ``torch.utils.checkpoint``
with ``remat`` (the reference's ``jax.checkpoint`` of its scan body).

Randomness: torch cannot reproduce JAX's key splits, so the trainers
take their random inputs as tensors (``draw_noise``: the flow net's
history frames past the first pair, and the first frame's warp input,
uniform in [-0.5, 0.5), drawn in float32 from a ``torch.Generator`` and
cast to the compute dtype); the parity tests feed the reference's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from joshupscale_torch.models.common import Mutables, merge_scan_bn_updates
from joshupscale_torch.ops.image import _luma
from joshupscale_torch.ops.warp import (
    dense_image_warp,
    dense_image_warp_via_s2d,
)
from joshupscale_torch.training import losses

Noise = Dict[str, torch.Tensor]


def preprocess_batch(x: torch.Tensor) -> torch.Tensor:
    """uint8 batches -> float32 in [-0.5, 0.5]; floats pass through."""
    if x.dtype == torch.uint8:
        return x.float() / 255.0 - 0.5
    return x


def _merge_bt(x: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) -> (B*T, ...)."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _split_bt(x: torch.Tensor, t: int) -> torch.Tensor:
    """(B*T, ...) -> (B, T, ...)."""
    return x.reshape((-1, t) + tuple(x.shape[1:]))


def sequence_brightness(inputs: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, 3) -> (B, T, 1, 1, 1) mean BGR luma of each frame
    (products rounded in the input's dtype, the mean in float32)."""
    luma = _luma(inputs.dtype, inputs.device)
    b = (inputs * luma).float().mean(dim=(2, 3, 4)).to(inputs.dtype)
    return b[:, :, None, None, None]


def uniform_noise(shape, generator: torch.Generator,
                  device) -> torch.Tensor:
    """Uniform [-0.5, 0.5) float32 draws."""
    return torch.rand(shape, generator=generator, device=device) - 0.5


def flow_history_frames(inputs_flow: torch.Tensor,
                        rand: Optional[torch.Tensor]) -> List[torch.Tensor]:
    """The flow net's history inputs past (cur, prev) for every pair:
    for pair t (cur frame t+1), history i is frame t-1-i where it
    exists, else a random frame: ``cat(rand[:, -(i+1):], inputs[:,
    :-(i+2)])`` along time.  ``rand`` is (B, K, H, W, 3), K history
    frames, or None for none."""
    if rand is None:
        return []
    t = inputs_flow.shape[1]
    rand = rand.to(inputs_flow.dtype)
    return [_merge_bt(torch.cat([rand[:, -(i + 1):],
                                 inputs_flow[:, :t - (i + 2)]], dim=1))
            for i in range(rand.shape[1])]


def draw_recurrent_noise(num_flow_frames: int, input_shape,
                         generator: torch.Generator, device) -> Noise:
    """A recurrent trainer's random inputs for a (B, T, H, W, 3) batch:
    ``first_warp`` (B, 4H, 4W, 3), the first generator call's warp
    input, and with more than two flow inputs ``history`` (B,
    num_flow_frames - 2, H, W, 3), the flow net's frames before the
    first."""
    b, _, h, w, _ = input_shape
    noise = {"first_warp": uniform_noise((b, h * 4, w * 4, 3), generator,
                                         device)}
    if num_flow_frames > 2:
        noise["history"] = uniform_noise((b, num_flow_frames - 2, h, w, 3),
                                         generator, device)
    return noise


def route_warp(use_s2d: bool, image: torch.Tensor,
               flow: torch.Tensor) -> torch.Tensor:
    """The training warp: through the s2d table
    (``dense_image_warp_via_s2d``) or in pixel space; the same values
    either way."""
    if use_s2d:
        return dense_image_warp_via_s2d(image, flow)
    return dense_image_warp(image, flow)


def run_recurrence(generator_apply, gen_params, first_out: torch.Tensor,
                   frames: torch.Tensor, flow_t: torch.Tensor,
                   bright_diff: Optional[torch.Tensor], warp,
                   training: bool, remat: bool, reducer=None):
    """The generator's recurrence after its first call (the reference's
    scan): step i warps the previous output (plus ``bright_diff[:, i]``)
    by ``flow_t[:, i]`` (``warp(image, flow)``) and runs the generator
    on ``frames[:, i]`` with a ``Mutables`` whose fade offset is i + 1.
    With ``remat`` (and grad enabled) each step runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of
    its scan body).  ``reducer``: the mesh of the batch statistics
    (``Mutables``).  Returns the outputs (the first included), the
    warped inputs and each step's BN updates."""

    def make_step(call_idx):
        def step(last_output, frame, flow, bd):
            if bd is not None:
                last_output = last_output + bd
            warped = warp(last_output, flow)
            mut = Mutables(training,
                           fade_offset=call_idx if training else 0,
                           reducer=reducer)
            out = generator_apply(gen_params, frame, warped, mut)
            return out, warped, mut.updates

        return step

    last = first_out
    outs, warps, step_updates = [first_out], [], []
    remat = remat and torch.is_grad_enabled()
    for i in range(frames.shape[1]):
        step = make_step(i + 1)
        args = (last, frames[:, i], flow_t[:, i],
                None if bright_diff is None else bright_diff[:, i])
        if remat:
            # The step's updates are returned, not recorded, so the
            # recomputation in the backward pass adds none.
            last, warped, upd = torch.utils.checkpoint.checkpoint(
                step, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            last, warped, upd = step(*args)
        outs.append(last)
        warps.append(warped)
        step_updates.append(upd)
    return outs, warps, step_updates


@dataclasses.dataclass(frozen=True)
class FRVSRTrainer:
    """Functional FRVSR training graph (reference ``FRVSRTrainer``).

    ``flow_apply(params, frames, mut)`` and ``generator_apply(params,
    frame, pre_warp, mut)`` are the nets' training forms.  Params,
    batch-norm statistics, the targets and every loss stay float32; the
    inputs and activations run in ``compute_dtype``.  ``s2d_train_warp``
    routes the supervision warp, ``s2d_scan_warp`` (None: as
    ``s2d_train_warp``) the recurrence's warp through the s2d table
    (``dense_image_warp_via_s2d``): the same values either way.
    """

    flow_apply: Callable[..., torch.Tensor]
    generator_apply: Callable[..., torch.Tensor]
    num_flow_frames: int = 4
    normalize_brightness: bool = False
    remat: bool = True
    compute_dtype: Any = torch.float32
    s2d_train_warp: bool = False
    s2d_scan_warp: Optional[bool] = True

    def _scan_warp(self, image, flow):
        use_s2d = (self.s2d_train_warp if self.s2d_scan_warp is None
                   else self.s2d_scan_warp)
        return route_warp(use_s2d, image, flow)

    def draw_noise(self, input_shape, generator: torch.Generator,
                   device) -> Noise:
        """The random inputs of one step on a (B, T, H, W, 3) batch."""
        return draw_recurrent_noise(self.num_flow_frames, input_shape,
                                    generator, device)

    def forward(self, params, inputs: torch.Tensor, targets: torch.Tensor,
                noise: Noise, training: bool = True,
                reducer=None) -> Dict[str, Any]:
        """The unrolled recurrent forward.

        inputs (B, T, H, W, 3), targets (B, T, 4H, 4W, 3), u8 or floats
        in [-0.5, 0.5]; ``noise`` from ``draw_noise``; ``reducer``: the
        mesh whose global batch the batch statistics span (None: this
        batch).  Returns
        ``gen_outputs`` (B, T, ...), ``target_warp`` (B, T-1, ...),
        ``gen_warp``, ``flow`` and ``bn_updates`` (the flow net's, and
        the generator's averaged over the recurrence's steps).
        """
        cdt = self.compute_dtype
        inputs = preprocess_batch(inputs).to(cdt)
        targets = preprocess_batch(targets)
        b, t, h, w, _ = inputs.shape
        mut = Mutables(training, reducer=reducer)

        if self.normalize_brightness:
            bright = sequence_brightness(inputs)
            bright_diff = bright[:, 1:] - bright[:, :-1]
            inputs_flow = inputs - bright
        else:
            bright_diff = None
            inputs_flow = inputs

        cur = _merge_bt(inputs_flow[:, 1:])
        prev = _merge_bt(inputs_flow[:, :-1])
        history = flow_history_frames(inputs_flow, noise.get("history"))
        flow = self.flow_apply(params["flow"], [cur, prev] + history,
                               mut.scoped("flow"))
        flow_t = _split_bt(flow, t - 1)

        # The supervision warp runs in the compute dtype, then float32.
        target_prev = _merge_bt(targets[:, :-1]).to(cdt)
        target_warp = _split_bt(
            route_warp(self.s2d_train_warp, target_prev, flow).float(),
            t - 1)
        if bright_diff is not None:
            target_warp = target_warp + bright_diff

        first_warp = noise["first_warp"].to(cdt)
        last = self.generator_apply(params["generator"], inputs[:, 0],
                                    first_warp, mut.scoped("generator"))
        outs, warps, step_updates = run_recurrence(
            self.generator_apply, params["generator"], last, inputs[:, 1:],
            flow_t, bright_diff, self._scan_warp, training, self.remat,
            reducer)
        if training and t > 1:
            merge_scan_bn_updates(mut, "generator.", step_updates)
        return {
            "gen_outputs": torch.stack(outs, dim=1),
            "target_warp": target_warp,
            "gen_warp": torch.stack(warps, dim=1) if warps else None,
            "flow": flow_t,
            "bn_updates": mut.updates,
        }

    def loss(self, params, batch: Dict[str, torch.Tensor], noise: Noise,
             l2_reg: float = 0.0, training: bool = True, reducer=None
             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Content L2 + warp L2 (+ l2 penalty); ``training=False`` runs
        inference batch norm, the validation route; ``reducer`` as in
        ``forward``."""
        targets = preprocess_batch(batch["target"])
        y = self.forward(params, batch["input"], targets, noise,
                         training=training, reducer=reducer)
        gen_outputs_loss = losses.channel_sum_mse(y["gen_outputs"], targets)
        target_warp_loss = losses.channel_sum_mse(y["target_warp"],
                                                  targets[:, 1:])
        loss = gen_outputs_loss + target_warp_loss
        if l2_reg:
            loss = loss + losses.l2_regularization(params, l2_reg)
        return loss, {
            "metrics": {"loss": loss, "gen_outputs_loss": gen_outputs_loss,
                        "target_warp_loss": target_warp_loss},
            "bn_updates": y["bn_updates"],
        }


@dataclasses.dataclass(frozen=True)
class FRVSRSingleTrainer:
    """One-step FRVSR training through an inference model's training
    form (reference ``FRVSRSingleTrainer``).

    Batch: ``input`` (B, num_flow_frames, H, W, 3), the window whose
    last frame is the current one; ``target`` (B, 4H, 4W, 3); ``last``
    (B, 4H, 4W, 3), the previous HR frame.  It draws no noise.
    """

    model: Any  # InferenceModel

    def draw_noise(self, input_shape, generator, device) -> Noise:
        return {}

    def loss(self, params, batch: Dict[str, torch.Tensor],
             noise: Optional[Noise] = None, l2_reg: float = 0.0,
             training: bool = True,
             reducer=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
        window = preprocess_batch(batch["input"])
        num_frames = window.shape[1]
        state = {
            "pre_gen": preprocess_batch(batch["last"]),
            "last_frames": [window[:, i] for i in range(num_frames - 1)],
        }
        target = preprocess_batch(batch["target"])
        mut = Mutables(training, reducer=reducer)
        outputs, _ = self.model.apply_train(params, window[:, -1], state,
                                            mut)
        gen_outputs_loss = losses.channel_sum_mse(outputs["output_raw"],
                                                  target)
        target_warp_loss = losses.channel_sum_mse(outputs["pre_warp"],
                                                  target)
        loss = gen_outputs_loss + target_warp_loss
        if l2_reg:
            loss = loss + losses.l2_regularization(params, l2_reg)
        return loss, {
            "metrics": {"loss": loss, "gen_outputs_loss": gen_outputs_loss,
                        "target_warp_loss": target_warp_loss},
            "bn_updates": mut.updates,
        }
