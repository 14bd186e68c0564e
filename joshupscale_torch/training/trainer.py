"""Training harness: the FRVSR and GAN train steps, Adam, checkpoints,
the fit loop.

Port of ``joshupscale_tpu/training/trainer.py``.  The params are a
nested dict of float32 tensors; the trainable leaves (every float leaf
but the batch-norm moving statistics and the fade schedule,
``losses.NON_TRAINABLE_KEYS``) require grad, and a step updates them in
place: the loss and its gradients by autograd, the freeze mask, Adam
(the reference's optax arithmetic), then the moving statistics the
forward pass collected.

The GAN step (``build_gan_step``) keeps two param groups, each with its
own Adam state: one forward pass, then the generator's loss
differentiated by the generator's leaves and the discriminator's loss
by the discriminator's.  The discriminator trains only while the
updated ``t_balance1`` EMA is under its threshold; that decision is one
host read of the EMA a step (Adam's bias corrections are host numbers
here, so a gate on the device would need a device count).

Checkpoints are flat ``.npz`` files in the reference's layouts and
under its keys (params, Adam's count and moments as optax's state
flattens them, the GAN's EMAs, the step), so a checkpoint either
package writes resumes in the other.

With a mesh (``parallel.mesh``, one rank per shard), a step is the
one-process step on the global batch, as the reference's GSPMD step is.
Each rank holds an equal slice of the batch and a replica of the state:
- Every loss term is a mean over per-sample quantities or a param-only
  term (``losses``' module docstring), so with equal shards the global
  loss is the ranks' mean loss, and its gradient the all-reduced mean
  of the ranks' gradients (the l2 term counted once).
- Batch norm takes its moments over the global batch (``Mesh.sum``,
  whose backward pass sums the gradient over the ranks too), so the
  moving statistics come out the same on every rank.
- The noise is drawn for the global batch from the same generator on
  every rank and sliced (``step_noise``).
- The metrics, and from them the GAN's gate and EMAs, are all-reduced
  means.
Adam then runs on identical gradients, and the replicas stay
bit-identical.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import queue as queue_mod
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from joshupscale_torch.export.weights import from_flat_numpy, to_flat_numpy
from joshupscale_torch.parallel.mesh import (
    batch_spec,
    local_batch,
    shard_batch,
)
from joshupscale_torch.training.frvsr import preprocess_batch
from joshupscale_torch.training.losses import trainable_leaves
from joshupscale_torch.training.schedules import get_learning_rate

# ---------------------------------------------------------------------------
# Freezing


def freeze_mask(params, frozen_paths: Tuple[str, ...],
                trainable: bool = True):
    """A tree of 0/1 multipliers shaped like ``params``: 0 for the leaves
    under a frozen dotted path, or all of them when not ``trainable``."""

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}.{k}" if path else str(k))
                    for k, v in tree.items()}
        frozen = (not trainable) or any(
            path == p or path.startswith(p + ".") for p in frozen_paths)
        return 0.0 if frozen else 1.0

    return walk(params, "")


def apply_mask(grads, mask):
    """``grads * mask`` leaf by leaf over two trees of ``mask``'s shape
    (``freeze_mask``'s multipliers): the reference's ``apply_mask``."""
    if isinstance(mask, dict):
        return {k: apply_mask(grads[k], m) for k, m in mask.items()}
    return grads * mask


def _leaf(tree, path: str):
    for part in path.split("."):
        tree = tree[part]
    return tree


# ---------------------------------------------------------------------------
# Batch-norm moving-statistic merge


def merge_bn_updates(params, updates: Dict[str, dict],
                     strip_prefixes: Tuple[str, ...] = ("",)):
    """Write collected updates (dotted path -> new values, as
    ``Mutables`` records them) into the param tree in place.  A path
    is tried against ``strip_prefixes`` in order; one that matches none
    is skipped (it belongs to another param group)."""
    with torch.no_grad():
        for path, stats in updates.items():
            for prefix in strip_prefixes:
                if prefix and not path.startswith(prefix):
                    continue
                node = _leaf(params, path[len(prefix):])
                for name, value in stats.items():
                    node[name].copy_(value)
                break
    return params


# ---------------------------------------------------------------------------
# Adam


class Adam:
    """``optax.adam(lr, b1, b2, eps)`` on the trainable leaves, in place.

    Per leaf: ``mu = (1-b1)*g + b1*mu``, ``nu = (1-b2)*g^2 + b2*nu``,
    then with the count ``c`` after its increment ``p -= lr * (mu /
    (1-b1^c)) / (sqrt(nu / (1-b2^c)) + eps)``: eps outside the root,
    as optax adds it.  ``lr`` is a float or a schedule of the count
    before the increment.  The state keeps moments for every leaf, the
    non-trainable ones at zero, because optax's state does.
    """

    def __init__(self, learning_rate=0.0005, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-7):
        self.learning_rate = get_learning_rate(learning_rate)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params) -> Dict[str, Any]:
        def zeros(tree):
            if isinstance(tree, dict):
                return {k: zeros(v) for k, v in tree.items()}
            return torch.zeros_like(tree, requires_grad=False)

        state = {"count": 0, "mu": zeros(params), "nu": zeros(params)}
        if callable(self.learning_rate):
            state["schedule_count"] = 0
        return state

    def lr(self, count: int) -> float:
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return self.learning_rate

    def update(self, params, grads: Dict[str, torch.Tensor],
               state: Dict[str, Any]) -> None:
        """One step on the leaves ``grads`` names (dotted paths)."""
        lr = self.lr(state.get("schedule_count", state["count"]))
        state["count"] += 1
        if "schedule_count" in state:
            state["schedule_count"] += 1
        count = np.float32(state["count"])
        bc1 = float(np.float32(1) - np.power(np.float32(self.b1), count))
        bc2 = float(np.float32(1) - np.power(np.float32(self.b2), count))
        paths = list(grads)
        g = [grads[p] for p in paths]
        p_ = [_leaf(params, p) for p in paths]
        mu = [_leaf(state["mu"], p) for p in paths]
        nu = [_leaf(state["nu"], p) for p in paths]
        with torch.no_grad():
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1 - self.b1))
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_add_(
                nu, torch._foreach_mul(torch._foreach_mul(g, g),
                                       1 - self.b2))
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, den)
            torch._foreach_mul_(upd, -lr)
            torch._foreach_add_(p_, upd)


def make_optimizer(learning_rate=0.0005) -> Adam:
    """Adam with Keras' defaults (b1 0.9, b2 0.999, eps 1e-7)."""
    return Adam(learning_rate)


# ---------------------------------------------------------------------------
# Train state


@dataclasses.dataclass
class TrainState:
    """Params, Adam's state and the count of steps taken."""

    params: Any
    opt_state: Any
    step: int

    def tree(self):
        return {"params": self.params, "opt_state": self.opt_state,
                "step": self.step}


def _trainable_copy(params):
    """A copy of ``params`` whose trainable leaves require grad."""
    trainable = {id(v) for _, v in trainable_leaves(params)}

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return tree.detach().clone().requires_grad_(id(tree) in trainable)

    return walk(params)


def to_device(tree, device):
    """A param tree's float32 tensors on ``device`` (the same tensors
    where they are there already)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device, torch.float32)


def init_train_state(params, optimizer: Adam, device=None) -> TrainState:
    """A fresh state that owns a copy of ``params`` (on ``device``, the
    CUDA device by default; registry models share param tensors between
    entries, and a step updates in place)."""
    from joshupscale_torch import resolve_device

    params = _trainable_copy(to_device(params, resolve_device(device)))
    return TrainState(params, optimizer.init(params), 0)


@dataclasses.dataclass
class GANTrainState:
    """Two param groups (generator + flow, discriminator), each with its
    Adam state, the t_balance EMAs with the count of discriminator
    steps, and the count of steps taken."""

    gen_params: Any
    discr_params: Any
    gen_opt_state: Any
    discr_opt_state: Any
    ema: Dict[str, Any]
    step: int

    def tree(self):
        return {"gen_params": self.gen_params,
                "discr_params": self.discr_params,
                "gen_opt_state": self.gen_opt_state,
                "discr_opt_state": self.discr_opt_state,
                "ema": self.ema, "step": self.step}


def init_gan_state(trainer, gen_params, discr_params, gen_optimizer: Adam,
                   discr_optimizer: Adam, device=None) -> GANTrainState:
    """A fresh GAN state owning copies of both groups (see
    ``init_train_state``) on ``device``."""
    from joshupscale_torch import resolve_device

    dev = resolve_device(device)
    gen_params = _trainable_copy(to_device(gen_params, dev))
    discr_params = _trainable_copy(to_device(discr_params, dev))
    return GANTrainState(gen_params, discr_params,
                         gen_optimizer.init(gen_params),
                         discr_optimizer.init(discr_params),
                         trainer.init_ema(dev), 0)


# ---------------------------------------------------------------------------
# The step


def _compute_dtype(trainer):
    model = getattr(trainer, "model", None)
    return getattr(trainer, "compute_dtype", None) or model.compute_dtype


@contextlib.contextmanager
def exact_float32(enabled: bool = True):
    """Within the block, no TF32 in cuDNN convs or cuBLAS products:
    float32 stays float32, as the reference computes it.  The flags are
    global, so they are set for the step only; the serving paths (bf16)
    do not see them."""
    if not enabled:
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def loss_and_grads(trainer, params, batch, noise, l2_reg: float = 0.0,
                   mask=None, reducer=None):
    """The forward and backward passes of one step: ``(loss, aux,
    grads)``, ``grads`` by dotted path for every trainable leaf the mask
    (``freeze_mask``) leaves free.  A frozen leaf gets no gradient, so
    Adam leaves it and its zero moments alone: what the reference's
    zeroed gradients do from the first step.  ``reducer``: the mesh of
    the batch statistics (this rank's gradients, not yet reduced)."""
    loss, aux = trainer.loss(params, batch, noise, l2_reg, reducer=reducer)
    return loss, aux, gradients(loss, grad_leaves(params, mask))


def grad_leaves(params, mask=None):
    """``(dotted path, tensor)`` of the leaves a step differentiates:
    the trainable ones that require grad and that ``mask`` leaves
    free."""
    return [(p, v) for p, v in trainable_leaves(params)
            if v.requires_grad and (mask is None or _leaf(mask, p))]


def gradients(loss: torch.Tensor, leaves,
              retain_graph: bool = False) -> Dict[str, torch.Tensor]:
    """The backward pass: ``d loss / d leaf`` by dotted path (zeros for
    a leaf the loss does not reach); ``retain_graph`` keeps the graph
    for another pull."""
    grads = torch.autograd.grad(loss, [v for _, v in leaves],
                                retain_graph=retain_graph,
                                allow_unused=True)
    return {p: (torch.zeros_like(v) if g is None else g)
            for (p, v), g in zip(leaves, grads)}


def apply_gradients(optimizer: Adam, state: TrainState, grads,
                    aux) -> None:
    """The optimizer part of a step, in place: Adam on the leaves
    ``grads`` names, then the forward pass's moving statistics; the
    step count advances."""
    optimizer.update(state.params, grads, state.opt_state)
    merge_bn_updates(state.params, aux["bn_updates"])
    state.step += 1


def step_noise(trainer, mesh, input_shape, rng: torch.Generator, device,
               noise=None):
    """A step's random inputs for a batch of ``input_shape``:
    ``noise`` if given, else ``trainer.draw_noise`` from ``rng``.  With
    a mesh, ``input_shape`` is this rank's and the noise is the global
    batch's (given, or drawn at the global shape from a generator every
    rank seeds alike), sliced to this rank's part on its device: every
    rank sees the one-process step's noise."""
    if mesh is None:
        if noise is None:
            noise = trainer.draw_noise(input_shape, rng, device)
        return noise
    if noise is None:
        shape = ((input_shape[0] * mesh.world_size,)
                 + tuple(input_shape[1:]))
        noise = trainer.draw_noise(shape, rng, device)
    return shard_batch(mesh, noise)


def build_frvsr_step(trainer, optimizer: Adam, mask=None,
                     l2_reg: float = 0.0, mesh=None,
                     steps_per_execution: int = 1) -> Callable:
    """The FRVSR (or single-step) train step: ``run(state, batch, rng=None,
    noise=None) -> (state, metrics)``, updating ``state`` in place.

    ``noise`` is the trainer's random inputs (``trainer.draw_noise``);
    without it they are drawn from the ``torch.Generator`` ``rng`` on
    the batch's device.  ``steps_per_execution`` K > 1 runs K optimizer
    steps on a stacked (K, B, ...) batch (``noise`` then a list of K)
    and averages their metrics, as the reference's scan does.  With a
    float32 compute dtype the step runs without TF32
    (``exact_float32``).

    ``mesh`` (a ``parallel.mesh.Mesh``): the step of one rank, on its
    slice of the global batch (``shard_batch`` along ``batch_spec(mesh,
    K)``) and a replicated state; ``noise``, where given, is the global
    batch's (the module docstring has the rules).
    """
    k = int(steps_per_execution)
    exact = _compute_dtype(trainer) == torch.float32

    def one(state, batch, rng, noise):
        noise = step_noise(trainer, mesh, batch["input"].shape, rng,
                           batch["input"].device, noise)
        _, aux, grads = loss_and_grads(trainer, state.params, batch,
                                       noise, l2_reg, mask, mesh)
        if mesh is not None:
            grads, metrics = mesh.mean(grads, aux["metrics"])
            aux = dict(aux, metrics=metrics)
        apply_gradients(optimizer, state, grads, aux)
        return {n: v.detach() for n, v in aux["metrics"].items()}

    def run(state: TrainState, batch, rng=None, noise=None):
        with exact_float32(exact):
            if k == 1:
                return state, one(state, batch, rng, noise)
            per_step = [
                one(state, {n: v[i] for n, v in batch.items()}, rng,
                    None if noise is None else noise[i])
                for i in range(k)]
        metrics = {n: torch.stack([m[n] for m in per_step]).mean()
                   for n in per_step[0]}
        return state, metrics

    run.steps_per_execution = k
    run.exact_float32 = exact
    run.mesh = mesh
    return run


def gan_losses(trainer, state: GANTrainState, batch, noise, vgg_params,
               l2_reg: float = 0.0, reducer=None):
    """The GAN step's forward pass: ``(terms, bn_updates)``, ``terms``
    from ``trainer.compute_losses`` against the state's EMAs;
    ``reducer``: the mesh of the batch statistics."""
    y = trainer.forward(state.gen_params, state.discr_params, vgg_params,
                        batch["input"], batch["target"], noise,
                        training=True, reducer=reducer)
    terms = trainer.compute_losses(y, state.ema, state.gen_params,
                                   state.discr_params, l2_reg)
    return terms, y["bn_updates"]


def gan_gradients(terms, state: GANTrainState, gen_mask=None,
                  discr_mask=None):
    """The two gradient pulls from one forward pass: ``gen_loss`` by the
    generator group's free leaves (the graph kept), then ``discr_loss``
    by the discriminator's."""
    gen = gradients(terms["gen_loss"], grad_leaves(state.gen_params,
                                                   gen_mask),
                    retain_graph=True)
    discr = gradients(terms["discr_loss"],
                      grad_leaves(state.discr_params, discr_mask))
    return gen, discr


def apply_gan_gradients(trainer, gen_optimizer: Adam,
                        discr_optimizer: Adam, state: GANTrainState,
                        gen_grads, discr_grads, terms, bn_updates,
                        threshold: Optional[float]) -> bool:
    """The GAN step's updates, in place: Adam on the generator group,
    its moving statistics, the EMAs; then, if the updated
    ``t_balance1`` EMA is under ``threshold`` (None: always), Adam on
    the discriminator -- its params and count do not move otherwise;
    then the discriminator's moving statistics (the real call's, as
    the reference keeps them).  Returns whether the discriminator
    trained."""
    gen_optimizer.update(state.gen_params, gen_grads, state.gen_opt_state)
    merge_bn_updates(state.gen_params, bn_updates, strip_prefixes=("gen.",))
    state.ema = trainer.update_ema(state.ema, terms["t_balance1"].detach(),
                                   terms["t_balance2"].detach())
    # The step's one synchronising call, after the generator's update is
    # queued; compared in float32, as the reference compares.
    trained = (threshold is None
               or float(state.ema["t_balance1"]) < np.float32(threshold))
    if trained:
        discr_optimizer.update(state.discr_params, discr_grads,
                               state.discr_opt_state)
    state.ema["discr_steps"] += int(trained)
    # In sorted path order, as the reference merges them: its updates
    # come back through ``jax.vjp``'s aux, a pytree whose dict keys are
    # sorted, so "discr.real.*" is written after "discr.fake.*" and the
    # real call's statistics are the ones kept.
    merge_bn_updates(state.discr_params, dict(sorted(bn_updates.items())),
                     strip_prefixes=("discr.real.", "discr.fake."))
    state.step += 1
    return trained


# Metrics of a K-step execution that take the last step's value: the
# cumulative count and the EMA snapshots.  The losses are averaged.
_CUMULATIVE = ("discr_steps", "t_balance1_avg", "t_balance2_avg")


def build_gan_step(trainer, gen_optimizer: Adam, discr_optimizer: Adam,
                   vgg_params, gen_mask=None, discr_mask=None,
                   l2_reg: float = 0.0, mesh=None,
                   steps_per_execution: int = 1) -> Callable:
    """The GAN train step: ``run(state, batch, rng=None, noise=None) ->
    (state, metrics)``, updating the ``GANTrainState`` in place (see
    ``apply_gan_gradients`` for the t_balance gate).

    ``vgg_params`` are copied to the batch's device once, without grad.
    ``noise`` and ``steps_per_execution`` as in ``build_frvsr_step``;
    with K > 1 the losses are averaged over the K steps and
    ``discr_steps``, ``t_balance1_avg`` and ``t_balance2_avg`` are the
    last step's.  With a float32 compute dtype the step runs without
    TF32 (``exact_float32``).  ``mesh`` as in ``build_frvsr_step``: the
    loss terms are all-reduced means before the EMAs and the gate read
    them, so every rank takes the same decision.
    """
    threshold = trainer.config()["t_balance1_threshold"]
    k = int(steps_per_execution)
    exact = _compute_dtype(trainer) == torch.float32
    vgg_on: Dict[torch.device, Any] = {}

    def one(state, batch, rng, noise):
        dev = batch["input"].device
        if dev not in vgg_on:
            vgg_on[dev] = to_device(vgg_params, dev)
        noise = step_noise(trainer, mesh, batch["input"].shape, rng, dev,
                           noise)
        terms, bn_updates = gan_losses(trainer, state, batch, noise,
                                       vgg_on[dev], l2_reg, mesh)
        gen_grads, discr_grads = gan_gradients(terms, state, gen_mask,
                                               discr_mask)
        if mesh is not None:
            gen_grads, discr_grads, terms = mesh.mean(gen_grads,
                                                      discr_grads, terms)
        apply_gan_gradients(trainer, gen_optimizer, discr_optimizer, state,
                            gen_grads, discr_grads, terms, bn_updates,
                            threshold)
        metrics = {n: v.detach() for n, v in terms.items()}
        metrics["discr_steps"] = torch.tensor(state.ema["discr_steps"])
        metrics["t_balance1_avg"] = state.ema["t_balance1"]
        metrics["t_balance2_avg"] = state.ema["t_balance2"]
        return metrics

    def run(state: GANTrainState, batch, rng=None, noise=None):
        with exact_float32(exact):
            if k == 1:
                return state, one(state, batch, rng, noise)
            per_step = [
                one(state, {n: v[i] for n, v in batch.items()}, rng,
                    None if noise is None else noise[i])
                for i in range(k)]
        metrics = {n: (per_step[-1][n] if n in _CUMULATIVE else
                       torch.stack([m[n] for m in per_step]).mean())
                   for n in per_step[0]}
        return state, metrics

    run.steps_per_execution = k
    run.exact_float32 = exact
    run.mesh = mesh
    return run


# ---------------------------------------------------------------------------
# Checkpoints (flat npz, the reference's keys)

# Adam's state under optax's flattened keys: ``optax.adam`` is a chain
# of (ScaleByAdamState(count, mu, nu), the learning rate's state), and
# a schedule's state is ScaleByScheduleState(count).
_OPT_KEYS = {"count": "0.0", "mu": "0.1", "nu": "0.2",
             "schedule_count": "1.0"}


def _flatten_state(tree) -> Dict[str, np.ndarray]:
    """A state tree (``TrainState.tree()`` or ``GANTrainState.tree()``)
    as the reference's flat keys: param groups in its layouts, Adam's
    state under optax's indices, the EMAs (``discr_steps`` int32), the
    step."""
    flat = {}
    for key, value in tree.items():
        if key.endswith("params"):
            flat.update(to_flat_numpy(value, key))
        elif key.endswith("opt_state"):
            for name, v in value.items():
                sub = f"{key}.{_OPT_KEYS[name]}"
                if isinstance(v, dict):
                    flat.update(to_flat_numpy(v, sub))
                else:
                    flat[sub] = np.asarray(v, np.int32)
        elif key == "ema":
            for name, v in value.items():
                dt = np.int32 if name == "discr_steps" else np.float32
                flat[f"ema.{name}"] = np.asarray(
                    v.detach().cpu() if torch.is_tensor(v) else v, dt)
        else:
            flat[key] = np.asarray(value, np.int32)
    return flat


def save_checkpoint(path: str, state_tree) -> None:
    """Save a train state (``TrainState.tree()`` or
    ``GANTrainState.tree()``) as a flat ``.npz``.
    The reference's other format, an Orbax directory, is not ported."""
    if not path.endswith(".npz"):
        raise NotImplementedError(
            "only .npz checkpoints are ported; the reference's Orbax "
            "checkpoints need orbax and jax")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten_state(state_tree))


def _restore(template, loaded, path=""):
    """``loaded`` checked against ``template``'s keys and shapes, on its
    devices and dtypes, requiring grad where it does."""
    if isinstance(template, dict):
        missing = set(template) - set(loaded)
        if missing:
            raise KeyError(f"missing in checkpoint at {path or '<root>'}: "
                           f"{sorted(missing)}")
        return {k: _restore(v, loaded[k], f"{path}.{k}" if path else k)
                for k, v in template.items()}
    if tuple(template.shape) != tuple(loaded.shape):
        raise ValueError(f"Shape mismatch for {path}: checkpoint "
                         f"{tuple(loaded.shape)} vs model "
                         f"{tuple(template.shape)}")
    return loaded.to(template.device, template.dtype).requires_grad_(
        template.requires_grad)


def load_checkpoint(path: str, template_tree):
    """A ``.npz`` checkpoint of either package, as a tree shaped like
    ``template_tree`` (``TrainState.tree()`` or
    ``GANTrainState.tree()``)."""
    if not path.endswith(".npz"):
        raise NotImplementedError(
            "only .npz checkpoints are ported; the reference's Orbax "
            "checkpoints need orbax and jax")
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}

    def sub(prefix):
        dot = prefix + "."
        return from_flat_numpy({k[len(dot):]: v for k, v in flat.items()
                                if k.startswith(dot)})

    out = {}
    for key, value in template_tree.items():
        if key.endswith("params"):
            out[key] = _restore(value, sub(key), key)
        elif key.endswith("opt_state"):
            opt = {}
            for name, v in value.items():
                k = f"{key}.{_OPT_KEYS[name]}"
                opt[name] = (_restore(v, sub(k), k) if isinstance(v, dict)
                             else int(flat[k]))
            out[key] = opt
        elif key == "ema":
            out[key] = {
                name: (int(flat[f"ema.{name}"]) if name == "discr_steps"
                       else torch.as_tensor(flat[f"ema.{name}"]).to(
                           v.device, torch.float32))
                for name, v in value.items()}
        else:
            out[key] = int(flat[key])
    return out


# ---------------------------------------------------------------------------
# Fit loop


class MeanAccumulator:
    """Running means of step metrics (the reference's Keras Mean
    trackers)."""

    def __init__(self):
        self._sums: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    def update(self, metrics: Dict[str, Any]) -> None:
        for k, v in metrics.items():
            self._sums[k] = self._sums.get(k, 0.0) + float(v)
            self._counts[k] = self._counts.get(k, 0) + 1

    def result(self) -> Dict[str, float]:
        return {k: self._sums[k] / max(self._counts[k], 1)
                for k in self._sums}

    def reset(self) -> None:
        self._sums.clear()
        self._counts.clear()


class TensorBoardLogger:
    """Scalar summaries through ``torch.utils.tensorboard``; a no-op
    where its ``tensorboard`` package is absent, as the reference's
    logger is without tensorflow."""

    def __init__(self, log_dir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._writer = None
        else:
            self._writer = SummaryWriter(log_dir)

    def scalars(self, metrics: Dict[str, float], step: int) -> None:
        if self._writer is None:
            return
        for k, v in metrics.items():
            self._writer.add_scalar(k, v, step)
        self._writer.flush()

    def histograms(self, params, step: int) -> None:
        """A histogram of every weight, by its dotted path in the
        reference's layout (the reference logs them every 20 epochs)."""
        if self._writer is None:
            return
        from joshupscale_torch.export.importer import flatten_params

        for path, arr in flatten_params(params).items():
            self._writer.add_histogram(path, arr, step)
        self._writer.flush()

    def images(self, tag: str, frames: np.ndarray, step: int) -> None:
        """(N, H, W, 3) uint8 RGB frames."""
        if self._writer is None:
            return
        self._writer.add_images(tag, frames, step, dataformats="NHWC")
        self._writer.flush()


def device_normalize(batch, device) -> Dict[str, torch.Tensor]:
    """A host batch -> tensors on ``device``, uint8 arrays normalized to
    [-0.5, 0.5] float32 there (a quarter of the bytes cross)."""
    return {k: preprocess_batch(torch.as_tensor(np.asarray(v)).to(device))
            for k, v in batch.items()}


class _InputStager:
    """Background thread staging host batches onto the device, one
    ahead of the step: it pulls the next host batch, copies it to the
    device on its own stream and normalizes it there
    (``device_normalize``), waits for that stream, and parks the batch
    in a 1-deep queue.  An exception in the source reaches the
    consumer."""

    _STOP = object()

    def __init__(self, batch_iter: Iterator, device: torch.device,
                 depth: int = 1):
        self._q: "queue_mod.Queue" = queue_mod.Queue(maxsize=max(depth, 1))
        self._cancel = threading.Event()
        self._device = device
        cuda = device.type == "cuda"

        def worker():
            stream = torch.cuda.Stream(device) if cuda else None
            try:
                for batch in batch_iter:
                    with (torch.cuda.stream(stream) if cuda
                          else contextlib.nullcontext()):
                        staged = device_normalize(batch, device)
                    if cuda:
                        stream.synchronize()
                    if not self._put(staged):
                        return
                self._put((self._STOP, None))
            except BaseException as exc:  # forwarded to the consumer
                self._put((self._STOP, exc))

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._cancel.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, tuple) and item and item[0] is self._STOP:
            self.close()
            if item[1] is not None:
                raise item[1]
            raise StopIteration
        if self._device.type == "cuda":
            # Made on the stager's stream, used on this one.
            current = torch.cuda.current_stream(self._device)
            for t in item.values():
                t.record_stream(current)
        return item

    def close(self):
        self._cancel.set()
        self._thread.join(timeout=5)


class _ProfileWindow:
    """``fit``'s profiler window: ``step()`` before each step opens a
    ``torch.profiler`` session once ``global_step`` reaches
    ``batch[0]`` and closes it once ``global_step`` passes ``batch[1]``;
    ``close()`` ends an open one.  Closing writes the trace into
    ``profile_dir``.  No-op without ``profile_dir``."""

    def __init__(self, profile_dir: Optional[str], batch: Tuple[int, int],
                 device: torch.device):
        self.profile_dir = profile_dir
        self.batch = batch
        self.device = device
        self.global_step = 0
        self._session = None
        self._done = profile_dir is None

    def step(self) -> None:
        if self._done:
            return
        if self._session is None and self.global_step >= self.batch[0]:
            from torch.profiler import (
                ProfilerActivity,
                profile,
                tensorboard_trace_handler,
            )

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._session = profile(
                activities=activities,
                on_trace_ready=tensorboard_trace_handler(self.profile_dir))
            self._session.start()
        elif self._session is not None and self.global_step > self.batch[1]:
            self.close()

    def close(self) -> None:
        if self._session is not None:
            session, self._session = self._session, None
            self._done = True
            session.stop()


def fit(step_fn: Callable, state, train_data: Iterable[Dict[str,
                                                            np.ndarray]],
        epochs: int, steps_per_epoch: int, rng: torch.Generator,
        val_fn: Optional[Callable] = None,
        val_data: Optional[Iterable[Dict[str, np.ndarray]]] = None,
        checkpoint_dir: Optional[str] = None, monitor: str = "loss",
        early_stopping_patience: Optional[int] = None,
        log_fn: Callable[[str], None] = print,
        epoch_callback: Optional[Callable] = None,
        tensorboard_dir: Optional[str] = None,
        profile_dir: Optional[str] = None,
        profile_batch: Tuple[int, int] = (5, 10),
        metric_lag: Optional[int] = None, stage_inputs: bool = True,
        cache_val_on_device: bool = False):
    """Epoch loop: train, validate, checkpoint best and latest.

    Batches go to ``rng``'s device (``device_normalize``; on a
    background thread with ``stage_inputs``).  Each step draws its noise
    from ``rng``; validation batch i draws from a generator seeded with
    i, so the monitored value moves with the model, not the draw.
    ``metric_lag`` bounds how many steps' metrics stay unread on the
    device (None: read them all once an epoch; 0: after every step).
    Stops on a non-finite train metric (TerminateOnNaN) and after
    ``early_stopping_patience`` epochs without a better monitored value.
    With ``profile_dir``, a ``torch.profiler`` trace (host ops, and the
    card's kernels on CUDA) covers global steps ``profile_batch[0]`` to
    ``profile_batch[1]`` inclusive, once, and is written there as
    TensorBoard's profile plugin reads it (``*.pt.trace.json``), also
    when ``fit`` raises inside the window (the reference's window, whose
    trace re-opens every other step after it, runs once here).

    A step built with a mesh (``step_fn.mesh``) runs on every rank:
    each rank reads the same global batches (``train_data`` and
    ``val_data`` alike, and ``rng`` seeded alike) and stages its slice
    (``local_batch``); the validation metrics are all-reduced means;
    only rank 0 logs, writes checkpoints and TensorBoard, runs
    ``epoch_callback`` and traces the profiler window.
    Returns ``(state, history)``.
    """
    device = rng.device
    mesh = getattr(step_fn, "mesh", None)
    lead = mesh is None or mesh.rank == 0
    if not lead:
        log_fn, tensorboard_dir, profile_dir = (lambda m: None), None, None
        checkpoint_dir = epoch_callback = None
    history = []
    best = float("inf")
    stale = 0
    acc = MeanAccumulator()
    pending: collections.deque = collections.deque()
    val_cache: list = []
    tb = TensorBoardLogger(tensorboard_dir) if tensorboard_dir else None
    spe = getattr(step_fn, "steps_per_execution", 1)
    exact = getattr(step_fn, "exact_float32", False)
    window = _ProfileWindow(profile_dir, profile_batch, device)

    def local(batch, k=1):
        return (batch if mesh is None
                else local_batch(mesh, batch, batch_spec(mesh, k)))

    if spe > 1 and steps_per_epoch % spe:
        log_fn(f"steps_per_epoch={steps_per_epoch} is not a multiple of "
               f"steps_per_execution={spe}; running "
               f"{max(steps_per_epoch // spe, 1) * spe} steps per epoch")

    def host_batches():
        it = iter(train_data)

        def next_batch():
            try:
                return next(it)
            except StopIteration:
                raise ValueError(
                    "train_data ran out of batches: the training stream "
                    "must be infinite (add a RepeatOp / repeat the "
                    "iterable) or cover epochs * steps_per_epoch "
                    "batches") from None

        while True:
            if spe > 1:
                group = [next_batch() for _ in range(spe)]
                yield local({k: np.stack([g[k] for g in group])
                             for k in group[0]}, spe)
            else:
                yield local(next_batch())

    if stage_inputs:
        batch_iter: Iterator = _InputStager(host_batches(), device)
    else:
        batch_iter = (device_normalize(b, device) for b in host_batches())

    def drain(keep: int = 0):
        while len(pending) > keep:
            acc.update({k: v.item() for k, v in pending.popleft().items()})

    try:
        for epoch in range(epochs):
            acc.reset()
            t0 = time.time()
            for _ in range(max(steps_per_epoch // spe, 1)):
                window.step()
                state, metrics = step_fn(state, next(batch_iter), rng=rng)
                window.global_step += spe
                pending.append(metrics)
                if metric_lag is not None:
                    drain(metric_lag)
            drain()
            train_metrics = acc.result()
            if any(not np.isfinite(v) for v in train_metrics.values()):
                log_fn(f"epoch {epoch}: non-finite metric, terminating: "
                       f"{train_metrics}")
                break

            entry = {"epoch": epoch, "time": time.time() - t0,
                     **{f"train_{k}": v for k, v in train_metrics.items()}}
            if val_fn is not None and val_data is not None:
                vacc = MeanAccumulator()
                batches = val_cache or (device_normalize(local(b), device)
                                        for b in val_data)
                with exact_float32(exact):
                    for val_i, batch in enumerate(batches):
                        if cache_val_on_device and len(val_cache) <= val_i:
                            val_cache.append(batch)
                        gen = torch.Generator(device).manual_seed(val_i)
                        metrics = val_fn(state, batch, gen)
                        if mesh is not None:
                            (metrics,) = mesh.mean(metrics)
                        vacc.update({k: v.item()
                                     for k, v in metrics.items()})
                entry.update({f"val_{k}": v
                              for k, v in vacc.result().items()})

            history.append(entry)
            if tb is not None:
                tb.scalars({k: v for k, v in entry.items()
                            if k != "epoch" and isinstance(v, float)},
                           step=epoch)
            log_fn(f"epoch {epoch}: " + " ".join(
                f"{k}={v:.4g}" for k, v in entry.items() if k != "epoch"))

            tree = state.tree() if hasattr(state, "tree") else state
            if checkpoint_dir is not None:
                save_checkpoint(os.path.join(checkpoint_dir, "latest.npz"),
                                tree)
                with open(os.path.join(checkpoint_dir, "history.json"),
                          "w") as f:
                    json.dump(history, f)
            current = entry.get(f"val_{monitor}",
                                entry.get(f"train_{monitor}"))
            if current is not None and current < best:
                best = current
                stale = 0
                if checkpoint_dir is not None:
                    save_checkpoint(
                        os.path.join(checkpoint_dir, "best.npz"), tree)
            else:
                stale += 1
            if epoch_callback is not None:
                epoch_callback(epoch, state, entry)
            if (early_stopping_patience is not None
                    and stale >= early_stopping_patience):
                log_fn(f"early stopping at epoch {epoch}")
                break
    finally:
        window.close()
        if isinstance(batch_iter, _InputStager):
            batch_iter.close()
    return state, history
