"""GAN training soak at the full reference architecture.

Port of ``tools/gan_soak.py``: the TecoGAN step (``build_gan_step``:
flow 64x10 + generator 64x24 + discriminator + VGG19 at seed 0, the
19-frame ping-pong) runs ``--steps`` steps on synthetic video batches
(``synth_video_batch``: smooth random fields with a temporal drift, the
reference tool's numpy draws) and prints the loss path, a JSON line
every ``--log-every`` steps.  ``--ablate`` zeroes loss terms
(comma-separated ``loss_config`` keys).  Exit 1 on a non-finite metric
or when the content loss did not decrease.

    python -m joshupscale_torch.tools.gan_soak [--steps 400] [--crop 32] \\
        [--batch 4] [--log-every 25] [--ablate vgg_loss,adv_loss] [--cpu]

Runs on the card unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

GAN_CONFIG = {
    "flow": {"name": "flow-resnet", "num_inputs": 4, "num_filters": 64,
             "num_res_blocks": 10},
    "generator": {"name": "generator-resnet", "num_filters": 64,
                  "num_res_blocks": 24},
    "discriminator": {"name": "discriminator", "alpha": 0.25},
    "vgg": {"name": "vgg"},
    "gan": {"name": "gan", "flow": {"model": "flow"},
            "generator": {"model": "generator"},
            "discriminator": {"model": "discriminator"},
            "vgg": {"model": "vgg"}},
}


def synth_video_batch(rng, batch_size, crop):
    """A synthetic "video" batch: smooth random fields with a temporal
    drift, so the flow and warp terms see coherent motion; floats in
    [-0.5, 0.5], the LR the 4x4 mean of the HR."""
    base = rng.random((batch_size, 1, crop * 4, crop * 4, 3), np.float32)
    drift = rng.random((batch_size, 10, 1, 1, 3), np.float32) * 0.1
    hr = np.clip(base + drift, 0.0, 1.0) - 0.5
    lr = hr.reshape(batch_size, 10, crop, 4, crop, 4, 3).mean((3, 5))
    return {"input": lr, "target": hr}


def soak(steps: int, crop: int, batch: int, device, log_every: int = 25,
         ablate: str = "", log=print):
    """Run the GAN step ``steps`` times on ``synth_video_batch``es (numpy
    seed 0) from the ``GAN_CONFIG`` models at seed 0; returns the logged
    metrics (every ``log_every`` steps and the last, each printed as a
    JSON line) and the seconds the steps took, or None at the first
    non-finite metric."""
    import dataclasses

    import torch

    from joshupscale_torch.models.registry import create_models
    from joshupscale_torch.training.trainer import (
        build_gan_step,
        device_normalize,
        init_gan_state,
        make_optimizer,
    )

    built = create_models(GAN_CONFIG, seed=0)["gan"]
    trainer = built.obj
    if ablate:
        trainer = dataclasses.replace(trainer, loss_config=(
            trainer.loss_config
            + tuple((k, 0.0) for k in ablate.split(","))))
    gopt, dopt = make_optimizer(5e-5), make_optimizer(5e-5)
    step = build_gan_step(trainer, gopt, dopt, built.params["vgg"])
    state = init_gan_state(trainer, built.params["gen"],
                           built.params["discr"], gopt, dopt, device)

    rng = np.random.default_rng(0)
    gen = torch.Generator(device).manual_seed(0)
    t0 = time.perf_counter()
    history = []
    for i in range(steps):
        state, metrics = step(state, device_normalize(
            synth_video_batch(rng, batch, crop), device), rng=gen)
        if i % log_every == 0 or i == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            if not all(np.isfinite(v) for v in m.values()):
                print(f"step {i}: NON-FINITE metric: {m}", file=sys.stderr)
                return None, time.perf_counter() - t0
            m["step"] = i
            history.append(m)
            log(json.dumps({k: round(v, 5) for k, v in m.items()}))
    return history, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--crop", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--ablate", type=str, default="",
                    help="comma-separated loss keys to zero (debug)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    args = ap.parse_args(argv)

    from joshupscale_torch import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    history, dt = soak(args.steps, args.crop, args.batch, device,
                       args.log_every, args.ablate,
                       lambda m: print(m, flush=True))
    if history is None:
        return 1
    first, last = history[0], history[-1]
    print(f"\n{args.steps} steps in {dt:.1f}s "
          f"({dt / args.steps * 1e3:.1f} ms/step incl. host)")
    print(f"gen_loss {first['gen_loss']:.4f} -> {last['gen_loss']:.4f}; "
          f"content {first['content_loss']:.4f} -> "
          f"{last['content_loss']:.4f}; "
          f"discr_steps {int(last['discr_steps'])}")
    ok = last["content_loss"] < first["content_loss"]
    print("content loss decreased:", ok)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
