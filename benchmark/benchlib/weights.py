"""Seeded weights, made on the device in two large draws.

The program's registry gives the structure of the raw param tree (keys,
shapes, layouts); every leaf's value comes from here, from the run's
seed, with a ``torch.Generator`` on the run's device: one uniform draw
for all the kernels and moving variances, one normal draw for all the
moving means, then each leaf is a scaled slice.  The configuration's
``weights`` entry holds the scales (``assumed`` sizes: the weights are
random, and damped so that activations stay O(1) through the res blocks
and the output is not clipped flat):

- conv kernels: glorot uniform (a transposed conv's (I, 4*O) product
  with fans 4*I and 4*O);
- batch norm: gamma 1 (``res_bn2_gamma`` on each res block's bn_2), beta
  0, moving mean N(0, ``bn_mean_std``), moving variance
  1 + U(0, ``bn_var_spread``);
- biases 0, but the flow head's: the traffic's pan in HR pixels, so the
  flow is the pan plus the head's damped (``flow_head_gain``) random
  part, as a trained flow net tracks a panned scene;
- the generator's last transposed conv damped by ``gen_tail_gain``.

The same seed gives the same weights on the same kind of device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def _leaves(tree, path="") -> List[Tuple[str, dict, str]]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        p = f"{path}.{k}" if path else k
        if isinstance(v, dict):
            out += _leaves(v, p)
        else:
            out.append((p, tree, k))
    return out


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def seeded_params(template, models: dict, scales: Dict[str, float],
                  pan_hr_px, seed: int, device) -> dict:
    """A raw param tree shaped as ``template`` ({"flow", "generator"}),
    float32 on ``device``, its values drawn from ``seed``; ``models``
    (the configuration's model dict) says which nets are resnets."""
    tree = _clone_structure(template, device)
    leaves = _leaves(tree)
    uni = [(p, d, k) for p, d, k in leaves
           if k in ("kernel", "moving_variance")]
    nrm = [(p, d, k) for p, d, k in leaves if k == "moving_mean"]
    g = generator(seed, device)
    u = torch.rand(sum(d[k].numel() for _, d, k in uni), generator=g,
                   device=device) * 2 - 1
    n = torch.randn(sum(d[k].numel() for _, d, k in nrm), generator=g,
                    device=device)
    at = 0
    for path, d, k in uni:
        t = d[k]
        part = u[at:at + t.numel()].view(t.shape)
        at += t.numel()
        if k == "moving_variance":
            d[k] = 1 + (part + 1) / 2 * scales["bn_var_spread"]
            continue
        if t.dim() == 4:  # OHWI
            o, kh, kw, i = t.shape
            lim = math.sqrt(6.0 / (kh * kw * (i + o)))
        else:  # a transposed conv's (I, 4*O) product
            i, o4 = t.shape
            lim = math.sqrt(6.0 / (4 * i + o4))
        d[k] = part * lim
    at = 0
    for path, d, k in nrm:
        t = d[k]
        d[k] = n[at:at + t.numel()].view(t.shape) * scales["bn_mean_std"]
        at += t.numel()
    inf = models["inference"]
    resnets = {net for net in tree
               if models[inf[net]["model"]]["name"].endswith("resnet")}
    for path, d, k in leaves:
        if k != "gamma":
            continue
        parts = path.split(".")
        d[k] = torch.ones_like(d[k])
        if (parts[0] in resnets and parts[1].startswith("block_")
                and parts[2:] == ["bn_2", "gamma"]):
            d[k] *= scales["res_bn2_gamma"]
    flow_head = tree["flow"]["conv_2"]
    flow_head["kernel"] = flow_head["kernel"] * scales["flow_head_gain"]
    bias = torch.zeros_like(flow_head["bias"]).view(-1, 2)
    bias[:, 0], bias[:, 1] = float(pan_hr_px[0]), float(pan_hr_px[1])
    flow_head["bias"] = bias.view(-1)
    tail = tree["generator"]["conv_trans_2"]
    tail["kernel"] = tail["kernel"] * scales["gen_tail_gain"]
    return tree


def _clone_structure(template, device):
    if isinstance(template, dict):
        return {k: _clone_structure(v, device) for k, v in template.items()
                if k != "_meta"}
    return torch.zeros(tuple(template.shape), dtype=torch.float32,
                       device=device)


def clone(tree):
    """A deep copy of a param tree (the reference gets its own)."""
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return tree.clone()
