"""Port parity for the conv probe's kernels (P1, P2) and its tool.

The plain versions of ``joshupscale_torch/kernels/probes.py`` -- what a
CPU tensor runs -- are held against the JAX tool's own Pallas calls
(``tools/pallas_conv_probe.py``, loaded by path, run in interpret mode at
a small M on the same seeded inputs).  The kernels themselves are held
against the plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.

Tolerance: one bf16 ulp of the Pallas result element-wise (P1, P2
single) and two for the pair, plus the largest difference two f32
summation orders can make (``probe_dot_bound``,
``probe_patch_dot_bound``, ``pair_tail_bound``).  The pair is compared
on the first-product rows y1 both sides share: a y1 one ulp apart
(allowed by the single product's bound) spreads through nine copies of
w2.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from joshupscale_torch.kernels import _build
from joshupscale_torch.kernels.probes import (
    HALO,
    K,
    PW,
    bf16_ulp,
    pair_tail_bound,
    pair_tail_plain,
    probe_dot,
    probe_dot_bound,
    probe_dot_plain,
    probe_patch_dot,
    probe_patch_dot_bound,
    probe_patch_dot_plain,
    within_bound,
)

REPO = Path(__file__).resolve().parent.parent
BF16 = torch.bfloat16


@pytest.fixture()
def pallas_tool(monkeypatch):
    """The JAX tool, its Pallas calls interpreted and recorded, its
    timing stubbed out; returns (module, recorded calls)."""
    spec = importlib.util.spec_from_file_location(
        "pallas_conv_probe_under_test", REPO / "tools" / "pallas_conv_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    calls = []
    original = pl.pallas_call

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        call = original(*args, **kwargs)
        calls.append(call)
        return call

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    monkeypatch.setattr(mod, "per_iter_us", lambda fn, c: 0.0)
    return mod, calls


def _pair(rng, shape, scale=1.0):
    """The same bf16 values for JAX and torch."""
    v = rng.standard_normal(shape).astype(np.float32) * scale
    return jnp.asarray(v, jnp.bfloat16), torch.from_numpy(v).to(BF16)


def _np(y):
    return np.array(y.astype(jnp.float32))


def _tiles_equal(y: torch.Tensor, tile: int) -> bool:
    t = y.reshape(-1, tile, y.shape[-1])
    return bool((t == t[:1]).all())


@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("resident", [True, False],
                         ids=["resident", "streamed"])
def test_probe_dot_plain_matches_pallas(pallas_tool, monkeypatch, rng, n,
                                        resident):
    mod, calls = pallas_tool
    m, tile = 256, 64
    monkeypatch.setattr(mod, "M", m)
    mod.probe_dot(n, tile, resident)
    a_j, a_t = _pair(rng, (m, K))
    b_j, b_t = _pair(rng, (K, n))
    want = torch.from_numpy(_np(calls[-1](a_j, b_j)))
    got = probe_dot_plain(a_t, b_t, tile, resident)
    assert got.shape == (m, n) and got.dtype == BF16
    ok, err = within_bound(got, want,
                           probe_dot_bound(a_t, b_t, tile, resident, want))
    assert ok, err
    # Resident: every output tile is the first one, on both sides.
    assert _tiles_equal(want, tile) == resident
    assert _tiles_equal(got, tile) == resident


@pytest.mark.parametrize("pair", [False, True], ids=["single", "pair"])
def test_probe_patch_dot_plain_matches_pallas(pallas_tool, monkeypatch, rng,
                                              pair):
    mod, calls = pallas_tool
    m, tile = 192, 64
    monkeypatch.setattr(mod, "M", m)
    buf_rows = -(-(tile + 2 * HALO) // 8) * 8
    x_j, x_t = _pair(rng, (buf_rows, 64))
    w1_j, w1_t = _pair(rng, (K, 64), 0.05)
    w2_j, w2_t = _pair(rng, (K, 64), 0.05)
    mod.probe_patch_dot(tile_rows=tile, pair=False)
    y1_want = torch.from_numpy(_np(calls[-1](x_j, w1_j, w2_j)))
    y1_got = probe_patch_dot_plain(x_t, w1_t, w2_t, tile, False, m=m)
    ok, err = within_bound(y1_got, y1_want, probe_patch_dot_bound(
        x_t, w1_t, tile, y1_want, m=m))
    assert ok, err
    want, got = y1_want, y1_got
    if pair:
        mod.probe_patch_dot(tile_rows=tile, pair=True)
        want = torch.from_numpy(_np(calls[-1](x_j, w1_j, w2_j)))
        got = probe_patch_dot_plain(x_t, w1_t, w2_t, tile, True, m=m)
        # The plain second half on the Pallas y1 against the Pallas pair.
        y1 = y1_want[:tile].to(BF16)
        tail = pair_tail_plain(y1, x_t, w2_t).repeat(m // tile, 1)
        ok, err = within_bound(tail, want,
                               pair_tail_bound(y1, x_t, w2_t, want))
        assert ok, err
        # The whole plain pair, on the rows whose y1 both sides share.
        same = (y1_got == y1_want).all(dim=1)
        assert bool(same.float().mean() > 0.9)
        ok, err = within_bound(got[same], want[same], pair_tail_bound(
            y1, x_t, w2_t, want)[same])
        assert ok, err
    assert got.shape == (m, 64) and got.dtype == BF16
    # Every step reads the same input rows: all steps' outputs are equal.
    assert _tiles_equal(want, tile) and _tiles_equal(got, tile)


def test_probe_patch_dot_truncates_steps(rng):
    """steps = m // tile_rows: 250 // 77 = 3 steps, 231 rows."""
    x = torch.from_numpy(rng.standard_normal((77 + 2 * HALO + 8, 64)).astype(
        np.float32)).to(BF16)
    w = torch.from_numpy(rng.standard_normal((K, 64)).astype(
        np.float32) * 0.05).to(BF16)
    y = probe_patch_dot_plain(x, w, w, 77, True, m=250)
    assert y.shape == (231, 64) and _tiles_equal(y, 77)


def test_probe_bound_has_teeth(rng):
    """The agreement bound rejects a result of the other mode and a
    single element off by a few ulps."""
    a = torch.from_numpy(rng.standard_normal((256, K)).astype(
        np.float32)).to(BF16)
    b = torch.from_numpy(rng.standard_normal((K, 64)).astype(
        np.float32)).to(BF16)
    ref = probe_dot_plain(a, b, 64, True)
    bound = probe_dot_bound(a, b, 64, True, ref)
    assert within_bound(ref, ref, bound)[0]
    assert not within_bound(probe_dot_plain(a, b, 64, False), ref, bound)[0]
    off = ref.float().clone()
    i = int(off.abs().argmax())
    off.view(-1)[i] += 4 * float(bf16_ulp(off.view(-1)[i]))
    assert not within_bound(off, ref, bound)[0]


def test_probe_wrappers_run_plain_on_cpu_and_check_args(rng):
    a = torch.from_numpy(rng.standard_normal((128, 128)).astype(
        np.float32)).to(BF16)
    b = torch.from_numpy(rng.standard_normal((128, 64)).astype(
        np.float32)).to(BF16)
    before = probe_dot.launches
    assert torch.equal(probe_dot(a, b, 32, True),
                       probe_dot_plain(a, b, 32, True))
    assert probe_dot.launches == before  # the plain version is no launch
    with pytest.raises(ValueError, match="divide"):
        probe_dot(a, b, 48)  # the TPU call would leave rows undefined
    with pytest.raises(ValueError):
        probe_dot(a[:, :96], b[:96], 32)  # K not a multiple of 64
    with pytest.raises(ValueError):
        probe_dot(a, torch.zeros(128, 32, dtype=BF16), 32)  # N
    with pytest.raises(TypeError):
        probe_dot(a.float(), b.float(), 32)
    with pytest.raises(ValueError, match="device"):
        probe_dot(a.to("meta"), b.to("meta"), 32)

    x = torch.from_numpy(rng.standard_normal((16 + HALO + PW + 1, 64)).astype(
        np.float32)).to(BF16)
    w = torch.zeros(K, 64, dtype=BF16)
    before = probe_patch_dot.launches
    assert torch.equal(probe_patch_dot(x, w, w, 16, True, m=40),
                       probe_patch_dot_plain(x, w, w, 16, True, m=40))
    assert probe_patch_dot.launches == before
    with pytest.raises(ValueError, match="rows"):
        probe_patch_dot(x[:-1], w, w, 16, True, m=40)  # the residual row
    with pytest.raises(ValueError):
        probe_patch_dot(x, w, w, 41, m=40)  # no whole step
    with pytest.raises(ValueError):
        probe_patch_dot(x, w[:, :32], w, 16, m=40)


def test_build_digest_covers_shared_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh header must change every library's name, or
    the kernels that include it would not be rebuilt."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._lib_path("k")
    (tmp_path / "h.cuh").write_text("// v2\n")
    assert _build._lib_path("k") != before


def test_conv_probe_tool_needs_a_card():
    """Without a CUDA device the tool exits non-zero with a message; it
    never falls back to the CPU."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "-m", "joshupscale_torch.tools.conv_probe",
         "--variants", "dot64_resident"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "us" not in proc.stdout
