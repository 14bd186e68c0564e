"""Time the quality tier's replayed step of one checkout of the repo,
for comparing two commits on one card in one call:

    python3 joshupscale_torch/tools/ab_quality_step.py <checkout_dir>

run once per checkout, in turns (parent, change, change, parent), as a
script: with ``-m`` the package would come from the current directory
instead of the checkout, which ``main`` refuses.  It imports that
checkout's ``chip_smoke.py`` and package, builds its kernels, serves 4
frames on the quality tier's engine (seeded weights) and prints
``chip_smoke.time_steps``'s replayed times (two turns) and device-only
time on a line starting with ``AB``.  Needs a CUDA card.
"""

from __future__ import annotations

import os
import sys


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    import joshupscale_torch
    from joshupscale_torch.kernels import _build

    if not os.path.abspath(joshupscale_torch.__file__).startswith(root):
        raise RuntimeError(f"joshupscale_torch comes from "
                           f"{joshupscale_torch.__file__}, not {root}: "
                           f"run this file as a script")
    from joshupscale_torch.models.registry import create_models
    from joshupscale_torch.runtime.engine import Engine

    _build.build_all()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    built = create_models(cs.quality_config(), seed=0)["inference"]
    engine = Engine(built.obj, cs.seeded_params(torch, built, 0), device=dev)
    frames = cs.frames_for(4, 0)
    for f in frames:
        engine.process(f)
    t = cs.time_steps(torch, f"quality [{os.path.basename(root)}]", engine,
                      frames, dev)
    print(f"AB {os.path.basename(root)} replayed {t['replayed_ms']} device "
          f"{t['replayed_device_ms']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
