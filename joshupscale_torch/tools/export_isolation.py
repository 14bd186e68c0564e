"""Whether AOTInductor exports made one after the other in one process
are independent of each other.

    python -m joshupscale_torch.tools.export_isolation \\
        [--height 270 --width 480] [--frames 6] [--cpu]

Model A has the fast tier's widths (flow-resnet 32, generator 48; the
widths at which the traced-conv fault showed on the card), cut to 2 + 2
res blocks, with random, undamped weights and its flow head scaled to a
mean |flow| of 4 HR pixels; model B is the PS2-fast family (the flow
autoencoder 16...128, generator 48, cut to 2 res blocks).  bf16.  Each
scenario runs in a fresh spawned process, all side by side, and exports
its models in turn with ``save_package(..., export_aoti=True)``; the
last artifact is held to ``Engine`` over the frames:

- ``fresh``: A alone;
- ``after_b``: B, then A;
- ``after_a_unfixed``: A with ``nn.layers.conv_operands`` undone (the
  traced convs on channels-last views), then A;
- ``after_a_unfixed_unrepaired``: the same with
  ``export.package.clear_trace_caches`` undone, so that the second
  export starts from the first's fake-tensor dispatch cache;
- ``after_a_unfixed_unrepaired_dynamo_reset``: the same with
  ``torch._dynamo.reset()`` between the exports;
- ``after_a_unfixed_unrepaired_cache_dir``: the same with a fresh
  inductor cache directory for the second export.

Prints one JSON line a scenario: for the last artifact, each frame's
display difference (u8 mean, max) and float state difference (mean, in
u8 steps of its 1/255 unit) against ``Engine``, and whether every frame
is within the card-vs-CPU gate (mean 0.5, 1% off by more than 2).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import tempfile

import numpy as np

SCENARIOS = {
    "fresh": ["a"],
    "after_b": ["b", "a"],
    "after_a_unfixed": ["a_unfixed", "a"],
    "after_a_unfixed_unrepaired": ["unrepaired", "a_unfixed", "a"],
    "after_a_unfixed_unrepaired_dynamo_reset": [
        "unrepaired", "a_unfixed", "dynamo_reset", "a"],
    "after_a_unfixed_unrepaired_cache_dir": [
        "unrepaired", "a_unfixed", "cache_dir", "a"],
}
FLOW = 4.0  # model A's mean |flow|, HR pixels
SEED = 0  # the models' random init and the frames


def _config(family: str, h: int, w: int) -> dict:
    inference = {"name": "inference", "flow": {"model": "flow"},
                 "generator": {"model": "generator"},
                 "skip_processing": False, "frame_height": h,
                 "frame_width": w, "compute_dtype": "bfloat16"}
    if family == "a":
        flow = {"name": "flow-resnet", "num_inputs": 4, "num_filters": 32,
                "num_res_blocks": 2}
    else:
        flow = {"name": "flow-autoencoder", "num_inputs": 4,
                "filters": [16, 32, 64, 128, 64, 32, 16]}
        inference.update(flow_pad_factor=8, normalize_brightness=True)
    return {"flow": flow, "generator": {"name": "generator-resnet",
                                        "num_filters": 48,
                                        "num_res_blocks": 2},
            "inference": inference}


def _frames(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """Smooth moving patterns plus noise, (n, h, w, 3) u8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        base = [np.sin(xx * 0.045 + i * 0.4 + c) * np.cos(yy * 0.06 - i * 0.2)
                for c in range(3)]
        img = 127.5 + 90 * np.stack(base, -1)
        img += rng.standard_normal(img.shape) * 8
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(out)


def scale_flow(torch, built, frames, device, target=FLOW):
    """Scale a flow-resnet's head (linear) in ``built.params`` so that
    its mean |flow| over ``frames`` (eager, HR pixels; the first frame's,
    against zeros, left out) is ``target``; returns the mean |flow|
    before and after."""
    model = built.obj

    def mean_flow():
        serving = model.prepare_params(built.params, device)
        last = model.init_state(1, device=device)["last_frames"]
        flows = []
        with torch.no_grad():
            for f in frames:
                inter, st = model.apply_flow_stage(
                    serving, torch.from_numpy(f[None]).to(device),
                    {"last_frames": last})
                last = st["last_frames"]
                flows.append(float(inter["flow"].float().abs().mean()))
        return float(np.mean(flows[1:]))

    raw = mean_flow()
    for v in built.params["flow"]["conv_2"].values():
        v.mul_(target / raw)
    return raw, mean_flow()


def run_scenario(name, out, h, w, n, device):
    """One scenario (``SCENARIOS``) in this process; returns its
    record."""
    import torch

    from joshupscale_torch.export import package
    from joshupscale_torch.export.package import (
        load_aoti_step,
        save_package,
        state_leaves,
    )
    from joshupscale_torch.models.registry import create_models
    from joshupscale_torch.nn import layers
    from joshupscale_torch.runtime.engine import Engine

    device = torch.device(device)
    frames = _frames(n, h, w, SEED + 1)
    built = {}
    for family in ("a", "b"):
        config = _config(family, h, w)
        built[family] = (config, create_models(config, seed=SEED)[
            "inference"])
    _, flow = scale_flow(torch, built["a"][1], frames, device)
    fixed = layers.conv_operands
    path = None
    for i, step in enumerate(SCENARIOS[name]):
        if step == "unrepaired":
            package.clear_trace_caches = lambda: None
            continue
        if step == "dynamo_reset":
            torch._dynamo.reset()
            continue
        if step == "cache_dir":
            os.environ["TORCHINDUCTOR_CACHE_DIR"] = tempfile.mkdtemp(
                dir=out)
            continue
        config, model = built[step[0]]
        path = os.path.join(out, f"{name}_{i}_{step}")
        if step.endswith("_unfixed"):
            layers.conv_operands = lambda xt, wt: (xt, wt)
        try:
            save_package(path, config, model, export_aoti=True,
                         device=device)
        finally:
            layers.conv_operands = fixed
    config, model = built["a"]
    engine = Engine(model.obj, model.params, device=device)
    step = load_aoti_step(path)
    state = state_leaves(model.obj.init_state(1, device=device))
    rows = []
    for f in frames:
        with torch.no_grad():
            out_, *state = step(torch.from_numpy(f[None]).to(device),
                                *state)
        ref = engine.process(f)
        d = np.abs(out_[0].cpu().numpy().astype(np.int32)
                   - ref.astype(np.int32))
        kept = [float((np.abs(a.float().cpu().numpy()
                              - b.float().cpu().numpy()) * 255).mean())
                for a, b in zip(state, state_leaves(engine.state))
                if a.is_floating_point()]
        rows.append({"u8_mean": float(d.mean()), "u8_max": int(d.max()),
                     "share_over_2": float((d > 2).mean()),
                     "state_mean": max(kept)})
    within = all(r["u8_mean"] <= 0.5 and r["share_over_2"] <= 0.01
                 and r["state_mean"] <= 0.5 for r in rows)
    return {"scenario": name, "exports": SCENARIOS[name],
            "mean_flow": flow, "within_gate": within, "frames": rows}


def _child(args):
    return run_scenario(*args)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--cpu", action="store_true",
                    help="export and serve on the CPU (default: the card)")
    args = ap.parse_args(argv)

    from joshupscale_torch import resolve_device

    device = str(resolve_device("cpu" if args.cpu else None))
    with tempfile.TemporaryDirectory() as out:
        jobs = [(name, out, args.height, args.width, args.frames, device)
                for name in SCENARIOS]
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(len(jobs)) as pool:
            records = pool.map(_child, jobs)
    for record in records:
        print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
