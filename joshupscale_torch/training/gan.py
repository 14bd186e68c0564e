"""TecoGAN adversarial training: the ping-pong unroll, the temporal
discriminator, the VGG perceptual loss and the t_balance EMAs.

Port of ``joshupscale_tpu/training/gan.py``.  One forward pass serves
both losses (the generator's and the discriminator's); the train step
(``trainer.build_gan_step``) pulls each loss's gradients from it in
turn, the reference's ``jax.vjp`` with two cotangents.

The 19-frame ping-pong sequence (10 forward, 9 mirrored) runs the flow
net once over all 18 adjacent pairs, batched, and the generator frame by
frame (``frvsr.run_recurrence``, each step under
``torch.utils.checkpoint`` with ``remat``).  The discriminator sees the
first 18 frames as 6 consecutive triples: each triple stacked along the
channels, the triple with its outer frames warped toward the centre by
the (detached) flow and its border masked (the centre 3/4 kept), and the
bilinearly upscaled LR triple -- 27 channels.  The real branch runs
before the fake one; both record their batch-norm updates, and the step
keeps the real call's (``trainer.apply_gan_gradients``, as the
reference's step ends up doing).  VGG's real branch runs without a
graph: VGG is never trained and the targets need no gradient.

The random inputs come in as tensors (``draw_noise``: the flow net's
history frames and the first generator call's warp input, the
reference's two draws).  Params, batch-norm statistics, the losses, the
EMAs and the supervision warp's result stay float32; the four nets'
activations run in ``compute_dtype``, the real and the fake branches
alike.  The unroll is fixed at T = 10 frames: the discriminator's triple
indexing needs it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from joshupscale_torch.models.common import Mutables, merge_scan_bn_updates
from joshupscale_torch.ops.resize import upscale_bilinear
from joshupscale_torch.training import losses
from joshupscale_torch.training.frvsr import (
    Noise,
    _merge_bt,
    _split_bt,
    draw_recurrent_noise,
    flow_history_frames,
    preprocess_batch,
    route_warp,
    run_recurrence,
    sequence_brightness,
)


def pingpong(x: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) -> (B, 2T-1, ...): the frames, then frames T-2..0."""
    return torch.cat([x, torch.flip(x[:, :-1], dims=(1,))], dim=1)


def _group_channels(x: torch.Tensor, group: int = 3) -> torch.Tensor:
    """(B*T, H, W, C) with T = G*group -> (B*G, H, W, C*group): each
    run of ``group`` frames stacked along the channels, channel-major
    (channel c of frame j at c*group + j)."""
    _, h, w, c = x.shape
    x = x.reshape(-1, group, h, w, c).permute(0, 2, 3, 4, 1)
    return x.reshape(-1, h, w, c * group)


def _mask_border(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Zero what lies outside the centre 3/4 of an (N, 4h, 4w, C)
    tensor (``h``, ``w``: the LR size), as a product with a 0/1 mask."""
    work_h, work_w = h * 3, w * 3
    pad_h, pad_w = h * 2 - work_h // 2, w * 2 - work_w // 2
    rows = torch.arange(h * 4, device=x.device)
    cols = torch.arange(w * 4, device=x.device)
    row = (rows >= pad_h) & (rows < pad_h + work_h)
    col = (cols >= pad_w) & (cols < pad_w + work_w)
    mask = (row[:, None] & col[None, :]).to(x.dtype)
    return x * mask[None, :, :, None]


@dataclasses.dataclass(frozen=True)
class GANTrainer:
    """Functional TecoGAN training graph (reference ``GANTrainer``).

    Param groups: ``gen_params`` = {"flow", "generator"}; the
    discriminator's tree; VGG's params, passed apart and never
    differentiated.  ``flow_apply(params, frames, mut)``,
    ``generator_apply(params, frame, pre_warp, mut)``,
    ``discriminator_apply(params, x, mut)`` and ``vgg_apply(params, x)``
    are the nets' training forms.  ``loss_config`` is a tuple of
    ``(name, value)`` overrides of ``losses.DEFAULT_GAN_LOSS_CONFIG``.
    ``s2d_train_warp`` routes the supervision and discriminator warps,
    ``s2d_scan_warp`` (None: as ``s2d_train_warp``) the recurrence's,
    through the s2d table: the same values either way.
    """

    flow_apply: Callable[..., torch.Tensor]
    generator_apply: Callable[..., torch.Tensor]
    discriminator_apply: Callable[..., List[torch.Tensor]]
    vgg_apply: Callable[..., List[torch.Tensor]]
    num_flow_frames: int = 4
    normalize_brightness: bool = False
    loss_config: Tuple[Tuple[str, Any], ...] = ()
    remat: bool = True
    compute_dtype: Any = torch.float32
    s2d_train_warp: bool = True
    s2d_scan_warp: Optional[bool] = None

    def config(self) -> Dict[str, Any]:
        return losses.get_gan_loss_config(dict(self.loss_config))

    def _scan_warp(self, image, flow):
        use_s2d = (self.s2d_train_warp if self.s2d_scan_warp is None
                   else self.s2d_scan_warp)
        return route_warp(use_s2d, image, flow)

    def draw_noise(self, input_shape, generator: torch.Generator,
                   device) -> Noise:
        """The random inputs of one step on a (B, T, H, W, 3) batch."""
        return draw_recurrent_noise(self.num_flow_frames, input_shape,
                                    generator, device)

    # -- forward -----------------------------------------------------------

    def forward(self, gen_params, discr_params, vgg_params,
                inputs: torch.Tensor, targets: torch.Tensor, noise: Noise,
                training: bool = True, reducer=None) -> Dict[str, Any]:
        """The ping-pong forward: what the losses need, the debug taps
        (``flow_t``, ``t_vel``, the discriminator inputs and their warps)
        and ``bn_updates`` (the flow net's, the generator's -- the first
        call's overwritten by the recurrence's mean -- and the
        discriminator's, real then fake).

        inputs (B, 10, H, W, 3), targets (B, 10, 4H, 4W, 3), u8 or floats
        in [-0.5, 0.5]; ``noise`` from ``draw_noise``; ``reducer``: the
        mesh whose global batch every batch norm's statistics span (None:
        this batch).
        """
        cdt = self.compute_dtype
        inputs = preprocess_batch(inputs).to(cdt)
        targets = preprocess_batch(targets)
        b, t, h, w, _ = inputs.shape
        td = 2 * t - 1
        mut = Mutables(training, reducer=reducer)

        inputs_d = pingpong(inputs)
        targets_d = pingpong(targets)
        if self.normalize_brightness:
            bright_d = pingpong(sequence_brightness(inputs))
            bright_diff = bright_d[:, 1:] - bright_d[:, :-1]
            inputs_flow_d = inputs_d - bright_d
        else:
            bright_d = bright_diff = None
            inputs_flow_d = inputs_d

        # Flow over all 18 adjacent ping-pong pairs, one batched call.
        cur = _merge_bt(inputs_flow_d[:, 1:])
        prev = _merge_bt(inputs_flow_d[:, :-1])
        history = flow_history_frames(inputs_flow_d, noise.get("history"))
        flow = self.flow_apply(gen_params["flow"], [cur, prev] + history,
                               mut.scoped("gen.flow"))
        flow_t = _split_bt(flow, td - 1)

        # The supervision warp runs in the compute dtype, then float32.
        target_prev = _merge_bt(targets_d[:, :-1]).to(cdt)
        target_warp = _split_bt(
            route_warp(self.s2d_train_warp, target_prev, flow).float(),
            td - 1)
        if bright_diff is not None:
            target_warp = target_warp + bright_diff

        first_out = self.generator_apply(
            gen_params["generator"], inputs_d[:, 0],
            noise["first_warp"].to(cdt), mut.scoped("gen.generator"))
        outs, warps, step_updates = run_recurrence(
            self.generator_apply, gen_params["generator"], first_out,
            inputs_d[:, 1:], flow_t, bright_diff, self._scan_warp, training,
            self.remat, reducer)
        if training:
            merge_scan_bn_updates(mut, "gen.generator.", step_updates)
        gen_outputs = torch.stack(outs, dim=1)
        gen_warp = torch.stack(warps, dim=1)

        # VGG: real on the 10 base frames (mirrored to 19), fake on the
        # 19 generated ones.
        with torch.no_grad():
            vgg_real = self.vgg_apply(vgg_params,
                                      _merge_bt(targets).to(cdt))
        vgg_real = [pingpong(_split_bt(f, t)) for f in vgg_real]
        vgg_fake = [_split_bt(f, td) for f in
                    self.vgg_apply(vgg_params, _merge_bt(gen_outputs))]

        # The temporal discriminator on 6 triples of the first 18 frames.
        t_gen = _merge_bt(gen_outputs[:, :18])
        t_targets = _merge_bt(targets_d[:, :18]).to(cdt)
        t_inputs = _merge_bt(inputs_d[:, :18])
        if bright_d is not None:
            t_bright = _merge_bt(bright_d[:, :18])
            t_gen = t_gen - t_bright
            t_targets = t_targets - t_bright
            t_inputs = t_inputs - t_bright
        inputs_hi = _group_channels(
            upscale_bilinear(t_inputs.float(), 4).to(t_inputs.dtype))
        # Triple velocities: [flow into the centre from the previous
        # frame, 0, from the next], the next from the mirrored half
        # (pair flows 16, 13, ..., 1: the reference's [:, -2:-19:-3]).
        v_pre = flow_t[:, :18:3]
        v_nxt = torch.flip(flow_t, dims=(1,))[:, 1::3]
        t_vel = torch.stack([v_pre, torch.zeros_like(v_pre), v_nxt],
                            dim=2).reshape(-1, h * 4, w * 4, 2).detach()

        taps = {}

        def discr_input(frames, tag):
            raw = route_warp(self.s2d_train_warp, frames, t_vel)
            warped = _mask_border(_group_channels(raw), h, w)
            taps[f"warp_raw_{tag}"] = raw
            taps[f"warp_masked_{tag}"] = warped
            return torch.cat([_group_channels(frames), warped, inputs_hi],
                             dim=-1)

        discr_in_real = discr_input(t_targets, "real")
        discr_in_fake = discr_input(t_gen, "fake")
        real_output = self.discriminator_apply(
            discr_params, discr_in_real, mut.scoped("discr.real"))
        fake_output = self.discriminator_apply(
            discr_params, discr_in_fake, mut.scoped("discr.fake"))
        return {
            "gen_outputs": gen_outputs,
            "gen_warp": gen_warp,
            "target_warp": target_warp,
            "real_output": list(real_output),
            "fake_output": list(fake_output),
            "vgg_real_output": vgg_real,
            "vgg_fake_output": vgg_fake,
            "targets_d": targets_d,
            "flow_t": flow_t,
            "t_vel": t_vel,
            "discr_in_real": discr_in_real,
            "discr_in_fake": discr_in_fake,
            **taps,
            "bn_updates": mut.updates,
        }

    # -- losses ------------------------------------------------------------

    def compute_losses(self, y: Dict[str, Any],
                       ema: Dict[str, Any], gen_params=None,
                       discr_params=None,
                       l2_reg: float = 0.0) -> Dict[str, torch.Tensor]:
        """Every loss term, the generator's and the discriminator's
        totals, and the t_balance values.  The generator's adversarial
        term is gated by the EMAs of the previous step (``ema``)."""
        cfg = self.config()
        targets_d = y["targets_d"]
        gen_outputs = y["gen_outputs"]
        fake_output, real_output = y["fake_output"], y["real_output"]

        content_loss = losses.channel_sum_mse(gen_outputs, targets_d)
        warp_loss = losses.channel_sum_mse(y["target_warp"],
                                           targets_d[:, 1:])
        pp_loss = losses.ping_pong_loss(gen_outputs)
        adv_loss = losses.adversarial_loss(fake_output[-1])
        d_fake = losses.discr_fake_loss(fake_output[-1])
        d_real = losses.discr_real_loss(real_output[-1])
        layer_loss = losses.feature_matching_loss(
            real_output[:-1], fake_output[:-1], cfg["discr_layer_norms"])
        vgg_loss = losses.vgg_cosine_loss(y["vgg_real_output"],
                                          y["vgg_fake_output"])

        if cfg["t_balance2_threshold"] is not None:
            cond2 = torch.sign(ema["t_balance2"]
                               - cfg["t_balance2_threshold"]) / 2.0 + 0.5
            if cfg["t_balance1_threshold"] is not None:
                cond2 = torch.maximum(cond2, torch.sign(
                    ema["t_balance1"] - cfg["t_balance1_threshold"])
                    / 2.0 + 0.5)
        else:
            cond2 = 1.0

        gen_terms = []
        if cfg["content_loss"] > 0:
            gen_terms.append(cfg["content_loss"] * content_loss)
        if cfg["warp_loss"] > 0:
            gen_terms.append(cfg["warp_loss"] * warp_loss)
        if cfg["pp_loss"] > 0:
            gen_terms.append(cfg["pp_loss"] * pp_loss)
        if cfg["adv_loss"] > 0:
            gen_terms.append(cfg["adv_loss"] * cond2 * adv_loss)
        if cfg["discr_layer_loss"] > 0:
            gen_terms.append(cfg["discr_layer_loss"] * layer_loss)
        if cfg["vgg_loss"] > 0:
            gen_terms.append(cfg["vgg_loss"] * vgg_loss)
        gen_loss = sum(gen_terms)

        discr_terms = []
        if cfg["discr_fake_loss"] > 0:
            discr_terms.append(cfg["discr_fake_loss"] * d_fake)
        if cfg["discr_real_loss"] > 0:
            discr_terms.append(cfg["discr_real_loss"] * d_real)
        discr_loss = sum(discr_terms)

        if l2_reg and gen_params is not None:
            reg = losses.l2_regularization(gen_params, l2_reg)
            if discr_params is not None:
                reg = reg + losses.l2_regularization(discr_params, l2_reg)
            gen_loss = gen_loss + reg
            discr_loss = discr_loss + reg

        return {
            "gen_loss": gen_loss,
            "discr_loss": discr_loss,
            "content_loss": content_loss,
            "warp_loss": warp_loss,
            "pp_loss": pp_loss,
            "adv_loss": adv_loss,
            "discr_fake_loss": d_fake,
            "discr_real_loss": d_real,
            "discr_layer_loss": layer_loss,
            "vgg_loss": vgg_loss,
            "t_balance1": adv_loss - d_real,
            "t_balance2": adv_loss - d_fake,
        }

    def init_ema(self, device=None) -> Dict[str, Any]:
        """The t_balance EMAs (float32 scalars on ``device``) at 0 and the
        count of discriminator steps taken."""
        return {"t_balance1": torch.zeros((), device=device),
                "t_balance2": torch.zeros((), device=device),
                "discr_steps": 0}

    @staticmethod
    def update_ema(ema: Dict[str, Any], t1: torch.Tensor, t2: torch.Tensor,
                   decay: float = 0.99) -> Dict[str, Any]:
        """``value += (1 - decay) * (x - value)`` for both EMAs."""
        return {
            **ema,
            "t_balance1": ema["t_balance1"]
            + (1 - decay) * (t1 - ema["t_balance1"]),
            "t_balance2": ema["t_balance2"]
            + (1 - decay) * (t2 - ema["t_balance2"]),
        }
