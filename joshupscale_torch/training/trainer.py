"""Training harness: the FRVSR train step, Adam, checkpoints, the fit
loop.

Port of the FRVSR part of ``joshupscale_tpu/training/trainer.py``.  The
params are a nested dict of float32 tensors; the trainable leaves
(every float leaf but the batch-norm moving statistics and the fade
schedule, ``losses.NON_TRAINABLE_KEYS``) require grad, and a step
updates them in place: the loss and its gradients by autograd, the
freeze mask, Adam (the reference's optax arithmetic), then the moving
statistics the forward pass collected.

Checkpoints are flat ``.npz`` files in the reference's layouts and
under its keys (params, Adam's count and moments as optax's state
flattens them, the step), so a checkpoint either package writes resumes
in the other.  The data-parallel mesh is not ported (ROADMAP 14d): a
step runs on one device.
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


def init_train_state(params, optimizer: Adam, device=None) -> TrainState:
    """A fresh state that owns a copy of ``params`` (on ``device``, the
    CUDA device by default; registry models share param tensors between
    entries, and a step updates in place)."""
    from joshupscale_torch import resolve_device

    dev = resolve_device(device)

    def to_dev(tree):
        if isinstance(tree, dict):
            return {k: to_dev(v) for k, v in tree.items()}
        return tree.to(dev, torch.float32)

    params = _trainable_copy(to_dev(params))
    return TrainState(params, optimizer.init(params), 0)


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
                   mask=None):
    """The forward and backward passes of one step: ``(loss, aux,
    grads)``, ``grads`` by dotted path for every trainable leaf the mask
    (``freeze_mask``) leaves free.  A frozen leaf gets no gradient, so
    Adam leaves it and its zero moments alone: what the reference's
    zeroed gradients do from the first step."""
    loss, aux = trainer.loss(params, batch, noise, l2_reg)
    return loss, aux, gradients(loss, grad_leaves(params, mask))


def grad_leaves(params, mask=None):
    """``(dotted path, tensor)`` of the leaves a step differentiates:
    the trainable ones that require grad and that ``mask`` leaves
    free."""
    return [(p, v) for p, v in trainable_leaves(params)
            if v.requires_grad and (mask is None or _leaf(mask, p))]


def gradients(loss: torch.Tensor, leaves) -> Dict[str, torch.Tensor]:
    """The backward pass: ``d loss / d leaf`` by dotted path (zeros for
    a leaf the loss does not reach)."""
    grads = torch.autograd.grad(loss, [v for _, v in leaves],
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


def build_frvsr_step(trainer, optimizer: Adam, mask=None,
                     l2_reg: float = 0.0,
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
    """
    k = int(steps_per_execution)
    exact = _compute_dtype(trainer) == torch.float32

    def one(state, batch, rng, noise):
        if noise is None:
            noise = trainer.draw_noise(batch["input"].shape, rng,
                                       batch["input"].device)
        _, aux, grads = loss_and_grads(trainer, state.params, batch,
                                       noise, l2_reg, mask)
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
    return run


# ---------------------------------------------------------------------------
# Checkpoints (flat npz, the reference's keys)

# Adam's state under optax's flattened keys: ``optax.adam`` is a chain
# of (ScaleByAdamState(count, mu, nu), the learning rate's state), and
# a schedule's state is ScaleByScheduleState(count).
_OPT_KEYS = {"count": "0.0", "mu": "0.1", "nu": "0.2",
             "schedule_count": "1.0"}


def _flatten_state(tree) -> Dict[str, np.ndarray]:
    flat = to_flat_numpy(tree["params"], "params")
    for name, value in tree["opt_state"].items():
        key = "opt_state." + _OPT_KEYS[name]
        if isinstance(value, dict):
            flat.update(to_flat_numpy(value, key))
        else:
            flat[key] = np.asarray(value, np.int32)
    flat["step"] = np.asarray(tree["step"], np.int32)
    return flat


def save_checkpoint(path: str, state_tree) -> None:
    """Save a train state (``TrainState.tree()``) as a flat ``.npz``.
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
    ``template_tree`` (``TrainState.tree()``)."""
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

    opt = {}
    for name, value in template_tree["opt_state"].items():
        key = "opt_state." + _OPT_KEYS[name]
        if isinstance(value, dict):
            opt[name] = _restore(value, sub(key), key)
        else:
            opt[name] = int(flat[key])
    return {"params": _restore(template_tree["params"], sub("params"),
                               "params"),
            "opt_state": opt, "step": int(flat["step"])}


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
    Returns ``(state, history)``.
    """
    device = rng.device
    history = []
    best = float("inf")
    stale = 0
    acc = MeanAccumulator()
    pending: collections.deque = collections.deque()
    val_cache: list = []
    tb = TensorBoardLogger(tensorboard_dir) if tensorboard_dir else None
    spe = getattr(step_fn, "steps_per_execution", 1)
    exact = getattr(step_fn, "exact_float32", False)
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
                yield {k: np.stack([g[k] for g in group])
                       for k in group[0]}
            else:
                yield next_batch()

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
                state, metrics = step_fn(state, next(batch_iter), rng=rng)
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
                batches = val_cache or (device_normalize(b, device)
                                        for b in val_data)
                with exact_float32(exact):
                    for val_i, batch in enumerate(batches):
                        if cache_val_on_device and len(val_cache) <= val_i:
                            val_cache.append(batch)
                        gen = torch.Generator(device).manual_seed(val_i)
                        vacc.update({k: v.item() for k, v in
                                     val_fn(state, batch, gen).items()})
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
        if isinstance(batch_iter, _InputStager):
            batch_iter.close()
    return state, history
