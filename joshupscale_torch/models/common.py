"""Shared model blocks: conv+BN folds, res blocks, the inference fade scale.

Port of the inference subset of ``joshupscale_tpu/models/common.py``.
Parameter trees mirror the reference's Keras layer names (``conv_1``,
``bn_1``, ``block_3``...).

Serving runs on params prepared once when an engine is built
(``InferenceModel.prepare_params``), so a frame redoes no fold.  As in
the reference, batch norm is folded into a conv only when the conv is
float (``joshupscale_tpu/models/common.py conv_bn``): a float res block
becomes what the res-block conv (K1, ``kernels/resblock.py``) takes and
runs as two K1 launches (``conv_1`` with the bn_1 epilogue and act, then
``conv_2`` with the bn_2 epilogue x the fade scale, the residual and
act).  An int8 conv keeps its batch norm as ``x * scale + offset`` in
the compute dtype after the conv, and so does every conv of the
calibration route: the prepare functions take the net's dotted
``path`` there, and a conv given a path is never folded and carries the
path for the sweep's recorder (``nn.layers.recording``).

Training runs the raw params instead (``*_train`` functions): the
gradients must reach ``kernel``, ``gamma`` and ``beta``, so nothing is
folded while batch norm takes batch statistics, and ``Mutables``
collects the moving-statistic and fade-counter updates of a forward
pass (the reference's ``Mutables``).  With ``Mutables(False)`` the
training form runs inference batch norm (a float conv folded as the
reference's ``conv_bn`` folds it): the validation route.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from joshupscale_torch.kernels.markers import STAGES, stage_end
from joshupscale_torch.kernels.resblock import resblock_conv3x3
from joshupscale_torch.nn.layers import (
    activation_spec,
    batch_norm,
    batch_norm_init,
    batch_norm_train,
    conv2d,
    conv2d_init,
    fold_bn,
    get_activation,
    get_train_activation,
    prepare_conv_int8,
)


class Mutables:
    """Collects the batch-norm moving-statistic updates and fade-counter
    increments of one training forward pass: ``updates`` maps a dotted
    path (``prefix`` + the layer's path) to its new, detached values,
    which the trainer writes back into the params after the step
    (``training.trainer.merge_bn_updates``).  ``training=False`` is
    inference batch norm and records nothing.

    ``fade_offset``: how many generator calls preceded this one in the
    step (the reference's FadeInLayer adds 1 to its counter per call).
    ``reducer``: the mesh whose global batch the batch statistics span
    (``nn.layers.batch_norm_train``); None for this process's batch.
    """

    def __init__(self, training: bool = False, prefix: str = "",
                 updates=None, fade_offset: int = 0, reducer=None):
        self.training = training
        self.prefix = prefix
        self.updates = {} if updates is None else updates
        self.fade_offset = fade_offset
        self.reducer = reducer

    def scoped(self, prefix: str) -> "Mutables":
        """A view over the same updates under ``prefix.``."""
        return Mutables(self.training, f"{self.prefix}{prefix}.",
                        self.updates, self.fade_offset, self.reducer)

    def bn(self, params, path: str, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return batch_norm(params, x)
        y, upd = batch_norm_train(params, x, reducer=self.reducer)
        self.updates[self.prefix + path] = upd
        return y

    def fade_in(self, params, path: str, x: torch.Tensor) -> torch.Tensor:
        """``x * min(counter / max(period, 1), 1)`` with the counter
        advanced by ``fade_offset``; records ``counter + 1`` when
        training.  The scale is state, so no gradient reaches it."""
        counter = params["counter"].detach() + self.fade_offset
        scale = torch.clamp(
            counter.float() / torch.clamp(params["period"].detach(),
                                          min=1.0), max=1.0)
        y = x * scale.to(x.dtype)
        if self.training:
            self.updates[self.prefix + path] = {"counter": counter + 1}
        return y


def merge_scan_bn_updates(mut: Mutables, prefix: str, step_updates):
    """Fold the updates of the recurrence's generator calls (one dict a
    step, paths without ``prefix``) into ``mut.updates`` under
    ``prefix``: each moving statistic as the mean over the steps (every
    step updated from the same running value, so the mean is one
    momentum step with the steps' mean batch statistic), overwriting the
    first frame's (whose warp input is noise); a fade counter as the
    last step's.  The reference's ``merge_scan_bn_updates``."""
    for path, upd in step_updates[0].items():
        if "counter" in upd:
            mut.updates[prefix + path] = {
                "counter": step_updates[-1][path]["counter"]}
            continue
        mut.updates[prefix + path] = {
            stat: torch.stack([u[path][stat] for u in step_updates]).mean(0)
            for stat in upd}


def fade_scale(fade_params) -> torch.Tensor:
    """Inference fade-in scale ``min(counter / max(period, 1), 1)``
    (reference FadeInLayer at inference: a constant factor)."""
    counter = torch.as_tensor(fade_params["counter"]).float()
    period = torch.as_tensor(fade_params["period"]).float()
    return torch.clamp(counter / torch.clamp(period, min=1.0), max=1.0)


def res_block_init(rng: np.random.Generator, num_filters: int,
                   fade_in_period=None):
    params = {
        "conv_1": conv2d_init(rng, 3, num_filters, num_filters,
                              use_bias=False),
        "bn_1": batch_norm_init(num_filters),
        "conv_2": conv2d_init(rng, 3, num_filters, num_filters,
                              use_bias=False),
        "bn_2": batch_norm_init(num_filters),
    }
    if fade_in_period is not None:
        params["fade"] = {
            "counter": torch.zeros(()),
            "period": torch.tensor(float(fade_in_period)),
        }
    return params


def prepare_conv(conv_params, dtype: torch.dtype, path=None):
    """A conv's serving params: a float kernel (and bias) cast to
    ``dtype``; an int8 one as ``prepare_conv_int8`` makes it.  With
    ``path`` a float conv carries it for the calibration recorder (the
    reference's sweep records float convs only)."""
    if "kernel_q" in conv_params:
        return prepare_conv_int8(conv_params)
    out = {k: conv_params[k].to(dtype) for k in ("kernel", "bias")
           if k in conv_params}
    if path is not None:
        out["path"] = path
    return out


def prepare_bn(bn_params, dtype: torch.dtype):
    """Inference batch norm as a ``(scale, offset)`` pair in ``dtype``."""
    scale, offset = fold_bn(bn_params)
    return {"scale": scale.to(dtype), "offset": offset.to(dtype)}


def _float(conv_params) -> bool:
    return "kernel_q" not in conv_params


def fold_conv_bn(conv_params, bn_params, dtype: torch.dtype):
    """A float conv followed by inference batch norm as one conv's
    params for ``conv2d``: ``kernel * inv`` per output channel and an
    offset bias (plus the conv's own bias times ``inv``), cast to
    ``dtype`` -- the fold the reference's ``conv_bn`` does at
    inference."""
    inv, offset = fold_bn(bn_params)
    if "bias" in conv_params:
        offset = offset + conv_params["bias"].float() * inv
    kernel = conv_params["kernel"].float() * inv.view(-1, 1, 1, 1)
    return {"kernel": kernel.to(dtype), "bias": offset.to(dtype)}


def prepare_conv_bn(conv_params, bn_params, dtype: torch.dtype,
                    path=None):
    """A conv and its batch norm: folded into one conv (a float conv
    outside calibration), else ``{"conv", "bn"}`` for
    ``WholeFrame.conv_bn``'s unfolded route (``path``: the conv's dotted
    path, given for calibration)."""
    if path is None and _float(conv_params):
        return fold_conv_bn(conv_params, bn_params, dtype)
    return {"conv": prepare_conv(conv_params, dtype, path),
            "bn": prepare_bn(bn_params, dtype)}


def batch_norm_apply(bn, x: torch.Tensor) -> torch.Tensor:
    """``x * scale + offset`` on a ``prepare_bn`` pair, in one op."""
    return torch.addcmul(bn["offset"], x, bn["scale"])


def _fold_conv(conv_params, bn_params, dtype, fade=None):
    scale, offset = fold_bn(bn_params)
    if "bias" in conv_params:
        offset = offset + conv_params["bias"].float() * scale
    if fade is not None:
        scale = scale * fade
        offset = offset * fade
    return {"kernel": conv_params["kernel"].to(dtype).contiguous(),
            "scale": scale.contiguous(), "offset": offset.contiguous()}


def fold_res_block(params, dtype: torch.dtype):
    """Raw res-block params -> ``{"conv_1": {kernel, scale, offset},
    "conv_2": {...}}`` in K1's form (kernel OHWI in ``dtype``, scale and
    offset float32 with bn, conv bias and fade folded in)."""
    fade = fade_scale(params["fade"]) if "fade" in params else None
    return {
        "conv_1": _fold_conv(params["conv_1"], params["bn_1"], dtype),
        "conv_2": _fold_conv(params["conv_2"], params["bn_2"], dtype, fade),
    }


def unfold_res_block(params, dtype: torch.dtype, path=None):
    """Raw res-block params -> the unfolded route's: each conv
    (``prepare_conv``) with its batch norm in ``dtype`` and the fade
    scale in ``dtype`` (``path``: the block's dotted path)."""
    out = {}
    for i in ("1", "2"):
        out["conv_" + i] = prepare_conv(
            params["conv_" + i], dtype,
            None if path is None else f"{path}.conv_{i}")
        out["bn_" + i] = prepare_bn(params["bn_" + i], dtype)
    if "fade" in params:
        out["fade"] = fade_scale(params["fade"]).to(dtype)
    return out


def prepare_res_blocks(params, dtype: torch.dtype, path=None):
    """Every ``block_*`` of a net's params: folded for K1
    (``fold_res_block``) when both convs are float, else unfolded
    (``unfold_res_block``); all unfolded under calibration (``path``:
    the net's dotted path)."""
    out = {}
    for k, v in params.items():
        if not k.startswith("block_"):
            continue
        if path is None and _float(v["conv_1"]) and _float(v["conv_2"]):
            out[k] = fold_res_block(v, dtype)
        else:
            out[k] = unfold_res_block(
                v, dtype, None if path is None else f"{path}.{k}")
    return out


def res_block_apply(params, x: torch.Tensor, activation) -> torch.Tensor:
    """conv-bn-act-conv-bn(-fade)-add-act residual block: two K1 calls
    on a block folded by ``fold_res_block``, or the reference's unfolded
    ops on one from ``unfold_res_block``."""
    if "bn_1" in params:
        act = get_activation(activation)
        out = act(batch_norm_apply(params["bn_1"],
                                   conv2d(params["conv_1"], x)))
        out = batch_norm_apply(params["bn_2"], conv2d(params["conv_2"], out))
        if "fade" in params:
            out = out * params["fade"]
        return act(out + x)
    act, alpha = activation_spec(activation)
    c1, c2 = params["conv_1"], params["conv_2"]
    y = resblock_conv3x3(x, c1["kernel"], c1["scale"], c1["offset"],
                         None, act, alpha)
    return resblock_conv3x3(y, c2["kernel"], c2["scale"], c2["offset"],
                            x, act, alpha)


def res_blocks_apply(params, names, x: torch.Tensor,
                     activation) -> torch.Tensor:
    """Run consecutive folded res blocks (see ``prepare_res_blocks``)."""
    out = x.contiguous()
    for name in names:
        out = res_block_apply(params[name], out, activation)
    return out


def concat(*xs: torch.Tensor) -> torch.Tensor:
    return torch.cat(xs, dim=-1)


class WholeFrame:
    """How a serving step runs each kind of layer: here, on the whole
    frame, each as it is.

    The nets (``models/fnet.py``, ``models/generator.py``) and
    ``InferenceModel.apply`` take these rules as ``ops`` and run every
    layer through them, so ``parallel.rows.Rows``, the same rules on
    row slabs over devices, runs the same definitions.  A net passes its
    params to the rules as arguments, never inside a closure (the slab
    rules hand each slab its own device's copy).  ``scaled`` and
    ``padded`` give the rules of another grid (after a pool or an
    upscale, or the flow net's padded frame); on the whole frame they
    are the same rules."""

    def scaled(self, num: int, den: int = 1) -> "WholeFrame":
        return self

    def padded(self, top: int, bottom: int) -> "WholeFrame":
        return self

    def map(self, fn, *args):
        """A row-local layer: elementwise ops, 1x1 products, concats,
        depth/space reshapes, 2x2 pools."""
        return fn(*args)

    def conv(self, params, x):
        """``nn.layers.conv2d``."""
        return conv2d(params, x)

    def conv_bn(self, params, x):
        """A ``prepare_conv_bn`` result: the folded conv, or the conv
        then batch norm in ``x.dtype``."""
        if "bn" in params:
            return self.map(batch_norm_apply, params["bn"],
                            self.conv(params["conv"], x))
        return self.conv(params, x)

    def res_blocks(self, params, names, x, activation, path: str):
        """``res_blocks_apply`` (``path``: the net's name)."""
        return res_blocks_apply(params, names, x, activation)

    def upscale(self, scale: int, fn, *args):
        """``fn(*args)``, a TF1-bilinear upscale: its output row
        ``scale * r + k`` reads input rows ``r`` and ``r + 1``."""
        return fn(*args)

    def whole(self, fn, *args):
        """A layer with no row-local form (the moving average)."""
        return fn(*args)

    def reduce(self, fn, *args):
        """A value of the whole tensors (the brightness mean)."""
        return fn(*args)

    def warp(self, fn, table, flow):
        """``fn(table, flow)``, a warp that reads all of ``table``."""
        return fn(table, flow)

    def pad(self, x, top: int, bottom: int, left: int, right: int):
        """Zero rows and columns around ``x`` (onto the padded grid)."""
        return F.pad(x, (0, 0, left, right, top, bottom))

    def crop(self, x, top: int, bottom: int, left: int, right: int):
        """``pad``'s inverse, back from the padded grid."""
        return x[:, top:x.shape[1] - bottom, left:x.shape[2] - right]

    def record(self, name: str, x):
        """``x``, the output of the layer ``name``."""
        return x


WHOLE_FRAME = WholeFrame()


class StageMarks(WholeFrame):
    """The whole-frame rules with a stage marker
    (``kernels/markers.py``) launched at each of ``InferenceModel``'s
    stage boundaries: the flow, the warp, the generator's output.
    ``runtime.engine.Engine`` captures its marked frame graph with
    these."""

    def record(self, name: str, x):
        which = STAGES.get(name)
        return x if which is None else stage_end(which, x)


STAGE_MARKS = StageMarks()


# ---------------------------------------------------------------------------
# Training form (raw params)


def conv_bn_train(conv_params, bn_params, x: torch.Tensor, mut: Mutables,
                  path: str) -> torch.Tensor:
    """conv then batch norm on raw params: batch statistics when
    training, else the conv folded with inference batch norm (the
    reference's ``conv_bn``)."""
    if mut.training:
        return mut.bn(bn_params, path, conv2d(conv_params, x))
    return conv2d(fold_conv_bn(conv_params, bn_params, x.dtype), x)


# Inference batch-norm folding switch of ``conv_bn`` (the reference's;
# its calibration sweep turns it off).  The serving route folds in
# ``prepare_params`` instead and does not read it.
FOLD_BN = True


def conv_bn(conv_params, bn_params, x: torch.Tensor, mut: Mutables,
            path: str) -> torch.Tensor:
    """The reference's ``conv_bn`` on raw params: conv then batch norm,
    folded into the conv at inference (``conv_bn_train``) unless
    ``FOLD_BN`` is off or the conv is int8 (``kernel_q``: run through
    ``prepare_conv_int8``), which keep the explicit batch norm."""
    if "kernel_q" in conv_params:
        return mut.bn(bn_params, path,
                      conv2d(prepare_conv_int8(conv_params), x))
    if not (FOLD_BN or mut.training):
        return mut.bn(bn_params, path, conv2d(conv_params, x))
    return conv_bn_train(conv_params, bn_params, x, mut, path)


def res_block_train(params, x: torch.Tensor, activation, mut: Mutables,
                    path: str) -> torch.Tensor:
    """conv-bn-act-conv-bn(-fade)-add-act on raw params."""
    act = get_train_activation(activation)
    out = act(conv_bn_train(params["conv_1"], params["bn_1"], x, mut,
                            f"{path}.bn_1"))
    out = conv_bn_train(params["conv_2"], params["bn_2"], out, mut,
                        f"{path}.bn_2")
    if "fade" in params:
        out = mut.fade_in(params["fade"], f"{path}.fade", out)
    return act(out + x)


def res_blocks_train(params, names, x: torch.Tensor, activation,
                     mut: Mutables) -> torch.Tensor:
    for name in names:
        x = res_block_train(params[name], x, activation, mut, name)
    return x
