"""Hold the data-parallel train step against the one-process step.

The same params, global batches and noise go through
``build_frvsr_step`` (or ``build_gan_step``) on a mesh of ranks
(``parallel.mesh.launch``) and in one process; each run reports the
gradients of every optimizer update (the mesh's all-reduced), the
metrics, the params after the steps and the host time of each
execution, and the mesh run whether its ranks' params are
bit-identical.  The rank function lives here, in the package, because
spawned ranks import the port only.

    python -m joshupscale_torch.tools.mesh_parity [--devices cuda:0,cuda:0]
        [--flow 64x10] [--generator 64x24] [--batch 4] [--frames 10]
        [--crop 32] [--steps 2] [--gan] [--seed 0]

prints the comparison (``compare``) as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from joshupscale_torch import resolve_device
from joshupscale_torch.export.weights import (
    from_flat_numpy,
    nest_flat,
    to_flat_numpy,
)


def frvsr_models(flow=(64, 10), generator=(64, 24), gan: bool = False,
                 lr: float = 5e-4, compute_dtype: str = "float32") -> dict:
    """A registry config of the FRVSR trainer (or, with ``gan``, the
    TecoGAN trainer) over a flow-resnet and a generator-resnet of
    (filters, res blocks)."""
    models = {
        "flow": {"name": "flow-resnet", "num_inputs": 4,
                 "num_filters": flow[0], "num_res_blocks": flow[1],
                 "zero_init_tail": not gan},
        "generator": {"name": "generator-resnet",
                      "num_filters": generator[0],
                      "num_res_blocks": generator[1],
                      "zero_init_tail": not gan},
    }
    nets = {"flow": {"model": "flow"}, "generator": {"model": "generator"}}
    if gan:
        models["discriminator"] = {"name": "discriminator", "alpha": 0.25}
        models["vgg"] = {"name": "vgg"}
        models["gan"] = {"name": "gan", **nets,
                         "discriminator": {"model": "discriminator"},
                         "vgg": {"model": "vgg"}, "learning_rate": lr,
                         "compute_dtype": compute_dtype}
    else:
        models["frvsr"] = {"name": "frvsr", **nets, "learning_rate": lr,
                           "compute_dtype": compute_dtype}
    return models


@dataclasses.dataclass
class Run:
    """What both forms run: the registry config ``models`` with its
    trainer entry ``trainer``, global numpy batches (one per execution;
    (K, B, ...) stacks for ``steps_per_execution`` K), the global noise
    of each optimizer step (numpy dicts, ``trainer.draw_noise``'s
    shapes), and the initial params as a flat numpy dict (None: the
    registry's, from ``seed``; for the GAN, {"gen": ..., "discr":
    ...})."""

    models: Dict[str, Any]
    trainer: str
    batches: List[Dict[str, np.ndarray]]
    noises: List[Dict[str, np.ndarray]]
    params: Optional[Dict[str, Any]] = None
    seed: int = 0
    steps_per_execution: int = 1


class _Recording:
    """An optimizer that keeps host copies of the gradients it is given
    and of the params they were taken at (flat, in the reference's
    layouts, as ``to_flat_numpy`` writes params), then steps as
    ``inner``."""

    def __init__(self, inner):
        self.inner = inner
        self.grads: List[Dict[str, np.ndarray]] = []
        self.params: List[Dict[str, np.ndarray]] = []

    def init(self, params):
        return self.inner.init(params)

    def update(self, params, grads, state) -> None:
        # Copies: on the CPU ``to_flat_numpy`` may return views of the
        # tensors, which the update overwrites.
        for store, tree in ((self.grads, nest_flat(grads)),
                            (self.params, params)):
            store.append({k: v.copy()
                          for k, v in to_flat_numpy(tree).items()})
        self.inner.update(params, grads, state)


def _digest(flat: Dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(np.ascontiguousarray(flat[k]).tobytes())
    return h.hexdigest()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counting(mesh):
    """``mesh`` with a count of its all-reduces (``calls[0]``)."""
    from joshupscale_torch.parallel.mesh import Mesh

    @dataclasses.dataclass(frozen=True)
    class Counting(Mesh):
        calls: list = dataclasses.field(default_factory=lambda: [0])

        def all_reduce_(self, t):
            self.calls[0] += 1
            return super().all_reduce_(t)

    return Counting(**{f.name: getattr(mesh, f.name)
                       for f in dataclasses.fields(Mesh)})


def run_steps(mesh, run: Run, device=None) -> Dict[str, Any]:
    """``run`` on ``mesh`` (this rank's part; None: one process on
    ``device``, the card unless the caller names the CPU).  Returns the
    recorded gradients (``grads``; the GAN's ``discr_grads`` only where
    the gate opened) and the params each was taken at
    (``update_params``, the generator group's for the GAN), the metrics
    of each execution, the final params (flat numpy; ``discr_params``
    too for the GAN), ``step_ms`` (host time of each execution,
    synchronised), ``steps``, ``started`` (``time.time()`` on entry) and
    ``seconds`` (the run's wall time) and, on a mesh, ``all_reduces``
    (this rank's all-reduces in each execution) and ``digests``: every
    rank's sha256 of its final state."""
    started = time.time()
    from joshupscale_torch.models.registry import create_models
    from joshupscale_torch.parallel.mesh import batch_spec, local_batch
    from joshupscale_torch.training.trainer import (
        build_frvsr_step,
        build_gan_step,
        device_normalize,
        init_gan_state,
        init_train_state,
        make_optimizer,
    )

    dev = mesh.device if mesh is not None else resolve_device(device)
    if mesh is not None:
        mesh = _counting(mesh)
    built = create_models(run.models, seed=run.seed)[run.trainer]
    trainer = built.obj
    lr = built.config.get("learning_rate", 5e-4)
    k = run.steps_per_execution
    gan = built.kind == "gan"
    params = built.params
    if run.params is not None:
        params = ({g: from_flat_numpy(run.params[g])
                   for g in ("gen", "discr")} if gan
                  else from_flat_numpy(run.params))
    opt = _Recording(make_optimizer(lr))
    if gan:
        discr_opt = _Recording(make_optimizer(lr))
        step = build_gan_step(trainer, opt, discr_opt, built.params["vgg"],
                              mesh=mesh, steps_per_execution=k)
        state = init_gan_state(trainer, params["gen"], params["discr"], opt,
                               discr_opt, dev)
    else:
        step = build_frvsr_step(trainer, opt, mesh=mesh,
                                steps_per_execution=k)
        state = init_train_state(params, opt, dev)
    if mesh is not None:
        from joshupscale_torch.parallel.mesh import replicate

        state = type(state)(**replicate(mesh, state.tree()))

    out: Dict[str, Any] = {"metrics": [], "step_ms": [], "gates": [],
                           "emas": [], "all_reduces": []}
    noises = iter(run.noises)
    for batch in run.batches:
        if mesh is not None:
            batch = local_batch(mesh, batch, batch_spec(mesh, k))
        batch = device_normalize(batch, dev)
        noise = [next(noises) for _ in range(k)]
        if mesh is None:
            noise = [{n: torch.as_tensor(v).to(dev) for n, v in x.items()}
                     for x in noise]
        _sync(dev)
        calls = mesh.calls[0] if mesh is not None else 0
        t0 = time.perf_counter()
        steps_before = state.ema["discr_steps"] if gan else 0
        state, metrics = step(state, batch,
                              noise=noise[0] if k == 1 else noise)
        _sync(dev)
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        if mesh is not None:
            out["all_reduces"].append(mesh.calls[0] - calls)
        out["metrics"].append({n: float(v) for n, v in metrics.items()})
        if gan:
            out["gates"].append(state.ema["discr_steps"] - steps_before)
            out["emas"].append([float(state.ema["t_balance1"]),
                                float(state.ema["t_balance2"])])
    out["grads"] = opt.grads
    out["update_params"] = opt.params
    out["steps"] = state.step
    if gan:
        out["discr_grads"] = discr_opt.grads
        out["params"] = to_flat_numpy(state.gen_params)
        out["discr_params"] = to_flat_numpy(state.discr_params)
        whole = {**to_flat_numpy(state.gen_params, "gen"),
                 **to_flat_numpy(state.discr_params, "discr")}
    else:
        out["params"] = whole = to_flat_numpy(state.params)
    if mesh is not None:
        import torch.distributed as dist

        digests: List[Optional[str]] = [None] * mesh.world_size
        dist.all_gather_object(digests, _digest(whole), group=mesh.group)
        out["digests"] = digests
    out["started"], out["seconds"] = started, time.time() - started
    return out


def replay_grads(run: Run, params_seq: List[Dict[str, np.ndarray]],
                 device=None, updates: Optional[List[int]] = None
                 ) -> List[Dict[str, np.ndarray]]:
    """The one-process gradients of an FRVSR run's optimizer updates,
    each at the params ``params_seq`` gives for it (a run's
    ``update_params``; ``updates`` names the update of each entry,
    default 0, 1, ...) on that update's batch and noise: what the
    one-process step computes from the params another run's step held.
    After the first update, the mesh's and the one-process run's params
    part by round-off that Adam's first step turns into up to ``2 * lr``
    (the sign of a near-zero gradient), so a gradient is held against
    this replay, not against the free-running run."""
    from joshupscale_torch.models.registry import create_models
    from joshupscale_torch.training.trainer import (
        _trainable_copy,
        device_normalize,
        exact_float32,
        loss_and_grads,
        to_device,
    )

    dev = resolve_device(device)
    trainer = create_models(run.models, seed=run.seed)[run.trainer].obj
    k = run.steps_per_execution
    out = []
    for i, flat in zip(updates or range(len(params_seq)), params_seq):
        batch = run.batches[i // k]
        if k > 1:
            batch = {n: v[i % k] for n, v in batch.items()}
        params = _trainable_copy(to_device(from_flat_numpy(flat), dev))
        noise = {n: torch.as_tensor(v).to(dev)
                 for n, v in run.noises[i].items()}
        with exact_float32(trainer.compute_dtype == torch.float32):
            _, _, grads = loss_and_grads(trainer, params,
                                         device_normalize(batch, dev),
                                         noise)
        out.append(to_flat_numpy(nest_flat(grads)))
    return out


def run_many(mesh, runs: List[Run], device=None) -> List[Dict[str, Any]]:
    """``run_steps`` for each of ``runs`` in turn (one launch)."""
    return [run_steps(mesh, r, device) for r in runs]


def all_reduce_ms(mesh, numels=(64, 2 ** 21), n: int = 50) -> Dict[str, Any]:
    """ms per all-reduce of a float32 tensor of each size on this rank's
    device, the ranks in step (a barrier first): the backend's own
    (gloo takes CUDA tensors) and through an explicit host copy."""
    import torch.distributed as dist

    out = {}
    for numel in numels:
        t = torch.ones(numel, device=mesh.device)
        for form in ("device", "host"):
            def once():
                if form == "device":
                    mesh.all_reduce_(t)
                else:
                    host = t.cpu()
                    mesh.all_reduce_(host)
                    t.copy_(host)
            for _ in range(3):
                once()
            _sync(mesh.device)
            dist.barrier(group=mesh.group)
            t0 = time.perf_counter()
            for _ in range(n):
                once()
            _sync(mesh.device)
            out[f"{form} {numel}"] = (time.perf_counter() - t0) * 1e3 / n
    return out


def run_and_probe(mesh, runs: List[Run]) -> Dict[str, Any]:
    """``run_many``, then ``all_reduce_ms``."""
    return {"runs": run_many(mesh, runs), "all_reduce_ms": all_reduce_ms(mesh)}


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    """``|a - b| / |b|`` in the L2 norm (0 where both are 0)."""
    den = float(np.linalg.norm(b))
    num = float(np.linalg.norm(a.astype(np.float64) - b))
    return num / den if den else num


def compare(one: Dict[str, Any], mesh: Dict[str, Any],
            replay: Optional[List[Dict[str, np.ndarray]]] = None
            ) -> Dict[str, Any]:
    """The mesh run against the one-process run: the worst relative L2
    error of any recorded gradient (and where) against ``replay``
    (``replay_grads`` at the mesh's params) or else the one-process
    run's, the worst relative error of the first metric (``loss`` or
    ``gen_loss``) over the executions, the largest param difference,
    whether the ranks' params are bit-identical, the gate decisions and
    EMAs side by side (GAN), and the median step time of each form."""
    worst, where = 0.0, None
    for i, (g1, gm) in enumerate(zip(replay or one["grads"],
                                     mesh["grads"])):
        for p, ref in g1.items():
            r = rel_l2(gm[p], ref)
            if r > worst:
                worst, where = r, f"update {i} {p}"
    name = "gen_loss" if "gen_loss" in one["metrics"][0] else "loss"
    loss_rel = max(abs(m[name] - o[name]) / abs(o[name])
                   for o, m in zip(one["metrics"], mesh["metrics"]))
    return {
        "grad_rel": worst, "grad_where": where, "loss": name,
        "loss_rel": loss_rel,
        "param_max_diff": max(float(np.abs(mesh["params"][p]
                                           - one["params"][p]).max())
                              for p in one["params"]),
        "ranks_identical": len(set(mesh["digests"])) == 1,
        "gates": [one["gates"], mesh["gates"]],
        "emas": [one["emas"], mesh["emas"]],
        "step_ms": [float(np.median(one["step_ms"])),
                    float(np.median(mesh["step_ms"]))],
    }


def make_run(models: Dict[str, Any], trainer: str, batch: int, frames: int,
             crop: int, steps: int, seed: int = 0,
             steps_per_execution: int = 1) -> Run:
    """A ``Run`` of ``steps`` executions on seeded u8 batches (B, T,
    crop, crop, 3) -> (B, T, 4crop, 4crop, 3) and seeded noise."""
    from joshupscale_torch.models.registry import create_models

    rng = np.random.default_rng(seed)
    trainer_obj = create_models({**models}, seed=seed)[trainer].obj
    k = steps_per_execution
    lead = (k,) if k > 1 else ()
    batches = [{"input": rng.integers(0, 256, lead + (batch, frames, crop,
                                                      crop, 3), np.uint8),
                "target": rng.integers(0, 256, lead + (
                    batch, frames, 4 * crop, 4 * crop, 3), np.uint8)}
               for _ in range(steps)]
    gen = torch.Generator().manual_seed(seed)
    noises = [{n: v.numpy() for n, v in trainer_obj.draw_noise(
        (batch, frames, crop, crop, 3), gen, "cpu").items()}
        for _ in range(steps * k)]
    return Run(models, trainer, batches, noises, seed=seed,
               steps_per_execution=k)


def main(argv=None) -> int:
    from joshupscale_torch.parallel.mesh import launch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", default="cuda:0,cuda:0",
                    help="one device per rank, comma-separated")
    ap.add_argument("--flow", default="64x10", help="filters x blocks")
    ap.add_argument("--generator", default="64x24")
    ap.add_argument("--batch", type=int, default=4, help="global batch")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--crop", type=int, default=32)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--gan", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    def net(s):
        return tuple(int(x) for x in s.split("x"))

    devices = args.devices.split(",")
    models = frvsr_models(net(args.flow), net(args.generator), args.gan)
    run = make_run(models, "gan" if args.gan else "frvsr", args.batch,
                   args.frames, args.crop, args.steps, args.seed)
    one = run_steps(None, run, devices[0])
    mesh = launch(run_steps, len(devices), run, devices=devices)
    replay = (None if args.gan else
              replay_grads(run, mesh["update_params"], devices[0]))
    print(json.dumps(compare(one, mesh, replay)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
