"""Row slabs: one frame's tensors split by rows over a list of devices.

The machinery of ``parallel.serving.SpatialEngine``.  A ``Split`` is the
row partition of one grid: slab ``i`` holds the rows ``[bounds[i],
bounds[i + 1])`` of every NHWC tensor on that grid, on ``devices[i]``
(a device may be listed more than once).  ``Rows`` runs the serving
step's layers on slabs: the nets and ``InferenceModel.apply`` take it as
their ``ops`` in place of ``models.common.WholeFrame``, so there is one
definition of each net.  A layer runs on slabs in one of these ways,
each giving the whole-frame layer's values:

- **row-local** (``map``: elementwise ops, 1x1 convs and products,
  concats, depth/space reshapes, 2x2 pools on even boundaries): on each
  slab as it is;
- **halo** (3x3 convs, K1 included, and the x2 / x4 TF1-bilinear
  upscales): each slab takes the rows it reads from its neighbours
  (``Split.with_halo``: 1 above and 1 below for a 3x3 conv, 1 below for
  an upscale), the whole-frame function runs on slab plus halo, and the
  rows computed from the halo are cropped.  At the frame's own top and
  bottom there is no neighbour, so the function's own zero padding or
  edge clamp applies there, as on the whole frame.  K1 takes the slab
  plus halo as its ``(1, rows + 2, W, C)`` operand, and conv_2's
  residual is the same slab plus halo;
- **whole** (``whole``, ``reduce``): a layer with no row-local form (an
  int8 conv or res block, whose activation scale is the whole tensor's
  absmax; the moving average; the brightness mean) gathers its inputs
  whole onto the first device; its output is scattered back, or, for a
  reduction, copied to every slab's device;
- the **warp** reads the whole previous output: it is gathered onto
  each device once a frame, and each slab queries it at its global rows.

The per-pixel arithmetic of every layer is the whole-frame layer's, so
the slabs give its bytes wherever the library picks the same reduction
order for a slab's shape as for the frame's (``PERF.md`` and
``ROADMAP.md`` record where a CPU library does not).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from joshupscale_torch.kernels.resblock import resblock_conv3x3
from joshupscale_torch.models.common import WholeFrame, res_block_apply
from joshupscale_torch.nn.layers import activation_spec, conv2d

Slabs = List[torch.Tensor]


class Split:
    """The row partition ``bounds`` (``len(devices) + 1`` increasing
    ints from 0 to the grid's height) of one grid over ``devices``."""

    def __init__(self, bounds: Sequence[int], devices: Sequence):
        self.bounds = tuple(int(b) for b in bounds)
        self.devices = list(devices)
        if len(self.bounds) != len(self.devices) + 1 or self.bounds[0]:
            raise ValueError(f"bad split {self.bounds} for "
                             f"{len(self.devices)} devices")
        if any(a >= b for a, b in zip(self.bounds, self.bounds[1:])):
            raise ValueError(
                f"the split {self.bounds} leaves a slab empty: the frame "
                f"is too short for {len(self.devices)} slabs")

    @property
    def height(self) -> int:
        return self.bounds[-1]

    def rows(self, i: int):
        return self.bounds[i], self.bounds[i + 1]

    def scaled(self, num: int, den: int = 1) -> "Split":
        """The same slabs on a grid ``num / den`` times as tall (a pool
        or an upscale); every boundary must stay a whole row."""
        if any(b * num % den for b in self.bounds[:-1]):
            raise ValueError(f"split {self.bounds} is not on a multiple "
                             f"of {den}")
        bounds = [b * num // den for b in self.bounds[:-1]]
        return Split(bounds + [self.height * num // den], self.devices)

    def padded(self, top: int, bottom: int) -> "Split":
        """The same slabs with ``top`` rows added above the grid (to the
        first slab) and ``bottom`` below it (to the last)."""
        return Split([0] + [b + top for b in self.bounds[1:-1]]
                     + [self.height + top + bottom], self.devices)

    def scatter(self, x: torch.Tensor) -> Slabs:
        """A whole tensor (any device) -> its slabs."""
        return [x[:, a:b].to(d) for (a, b), d in
                zip(map(self.rows, range(len(self.devices))), self.devices)]

    def window(self, slabs: Slabs, i: int, lo: int, hi: int) -> torch.Tensor:
        """Rows ``[lo, hi)`` of the split tensor on slab ``i``'s device:
        its own rows and what it needs of its neighbours'."""
        parts = []
        for j, t in enumerate(slabs):
            a, b = self.rows(j)
            if max(lo, a) < min(hi, b):
                parts.append(t[:, max(lo, a) - a:min(hi, b) - a].to(
                    self.devices[i]))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def gather(self, slabs: Slabs, device) -> torch.Tensor:
        """The whole tensor on ``device``."""
        return torch.cat([t.to(device) for t in slabs], dim=1)

    def with_halo(self, fn: Callable[..., torch.Tensor], inputs, up: int,
                  down: int, scale: int = 1) -> Slabs:
        """``fn(i, *xs)`` on each slab ``i`` with ``up`` rows above and
        ``down`` below from its neighbours (none past the frame's
        edges), cropped back to the slab's rows; ``scale`` is the
        output's rows per input row."""
        out = []
        for i in range(len(self.devices)):
            a, b = self.rows(i)
            lo, hi = max(a - up, 0), min(b + down, self.height)
            y = fn(i, *[self.window(x, i, lo, hi) for x in inputs])
            top = (a - lo) * scale
            out.append(y[:, top:top + (b - a) * scale])
        return out


def param_copies(trees) -> Dict[int, list]:
    """One serving param tree per slab -> a map from each dict and
    tensor of the first tree (by ``id``) to that node in every tree."""
    copies: Dict[int, list] = {}

    def walk(nodes):
        if isinstance(nodes[0], dict):
            copies[id(nodes[0])] = nodes
            for key in nodes[0]:
                walk([n[key] for n in nodes])
        elif isinstance(nodes[0], torch.Tensor):
            copies[id(nodes[0])] = nodes

    walk(list(trees))
    return copies


class Rows(WholeFrame):
    """``WholeFrame``'s rules on the slabs of ``split``: a grid tensor is
    a list of slabs; params are the first slab's tree, and ``copies``
    (``param_copies``) gives each slab its own device's copy.  ``tap``,
    if given, is called as ``tap(name, whole)`` for each recorded layer
    (``whole()`` gathers its output onto the CPU)."""

    def __init__(self, split: Split, copies: Dict[int, list],
                 tap: Optional[Callable[[str, Callable], None]] = None):
        self.split = split
        self._copies = copies
        self._tap = tap

    def scaled(self, num: int, den: int = 1) -> "Rows":
        return Rows(self.split.scaled(num, den), self._copies, self._tap)

    def padded(self, top: int, bottom: int) -> "Rows":
        return Rows(self.split.padded(top, bottom), self._copies, self._tap)

    def _arg(self, a, i: int):
        """Slab ``i``'s value of an argument: its slab of a grid tensor,
        its copy of a param; any other value as it is."""
        if isinstance(a, list):
            return a[i]
        if isinstance(a, (dict, torch.Tensor)):
            return self._copies[id(a)][i]
        return a

    def map(self, fn, *args) -> Slabs:
        return [fn(*[self._arg(a, i) for a in args])
                for i in range(len(self.split.devices))]

    def _halo(self, fn, args, up: int, down: int, scale: int = 1) -> Slabs:
        """``fn(*args)`` on each slab plus ``up`` / ``down`` halo rows of
        every grid tensor argument."""
        grid = [a for a in args if isinstance(a, list)]

        def run(i, *windows):
            it = iter(windows)
            return fn(*[next(it) if isinstance(a, list) else self._arg(a, i)
                        for a in args])

        return self.split.with_halo(run, grid, up, down, scale)

    def conv(self, params, x: Slabs) -> Slabs:
        """A 1x1 conv row-locally, a k x k SAME conv (k odd) with k // 2
        halo rows, an int8 conv whole."""
        if "matrix_q" in params:
            return self.whole(conv2d, params, x)
        k = params["kernel"].shape[1]
        if k % 2 == 0:
            raise ValueError(f"no row-slab form for an even kernel ({k})")
        return self._halo(conv2d, (params, x), k // 2, k // 2)

    def res_blocks(self, params, names, x: Slabs, activation,
                   path: str) -> Slabs:
        """A block folded for K1 as two halo launches of K1 a slab
        (conv_2's residual the slab plus the same halo); an unfolded
        (int8) block whole."""
        act, alpha = activation_spec(activation)
        out = self.map(torch.Tensor.contiguous, x)
        for name in names:
            p = params[name]
            if "bn_1" in p:
                y = self.whole(res_block_apply, p, out, activation)
            else:
                c1, c2 = p["conv_1"], p["conv_2"]
                y = self._halo(resblock_conv3x3, (
                    out, c1["kernel"], c1["scale"], c1["offset"], None,
                    act, alpha), 1, 1)
                y = self._halo(resblock_conv3x3, (
                    y, c2["kernel"], c2["scale"], c2["offset"], out, act,
                    alpha), 1, 1)
            out = self.record(f"{path}.{name}", y)
        return out

    def upscale(self, scale: int, fn, *args) -> Slabs:
        return self._halo(fn, args, 0, 1, scale)

    def _wholes(self, args, device):
        return [self.split.gather(a, device) if isinstance(a, list) else a
                for a in args]

    def whole(self, fn, *args) -> Slabs:
        """``fn`` on the whole tensors on the first device (params: the
        first slab's), its output scattered back."""
        return self.split.scatter(fn(*self._wholes(args,
                                                   self.split.devices[0])))

    def reduce(self, fn, *args) -> Slabs:
        value = fn(*self._wholes(args, self.split.devices[0]))
        return [value.to(d) for d in self.split.devices]

    def warp(self, fn, table: Slabs, flow: Slabs) -> Slabs:
        """``table`` gathered whole onto each device once, each slab's
        warp at its global rows (``row0``)."""
        wholes: Dict[torch.device, torch.Tensor] = {}
        out = []
        for i, d in enumerate(self.split.devices):
            if d not in wholes:
                wholes[d] = self.split.gather(table, d)
            out.append(fn(wholes[d], flow[i], row0=self.split.rows(i)[0]))
        return out

    def pad(self, x: Slabs, top: int, bottom: int, left: int,
            right: int) -> Slabs:
        """Onto ``padded(top, bottom)``'s slabs: the top rows on the
        first slab, the bottom rows on the last."""
        last = len(x) - 1
        return [F.pad(t, (0, 0, left, right, top if i == 0 else 0,
                          bottom if i == last else 0))
                for i, t in enumerate(x)]

    def crop(self, x: Slabs, top: int, bottom: int, left: int,
             right: int) -> Slabs:
        """From ``padded(top, bottom)``'s slabs back to this grid's."""
        last = len(x) - 1
        return [t[:, top if i == 0 else 0:
                  t.shape[1] - (bottom if i == last else 0),
                  left:t.shape[2] - right] for i, t in enumerate(x)]

    def record(self, name: str, x: Slabs) -> Slabs:
        if self._tap is not None:
            self._tap(name, lambda: self.split.gather(x, "cpu"))
        return x
