"""The port's CUDA kernels against their plain versions, and the engine's
frame graph against eager steps, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from joshupscale_torch.kernels.display import (
    d2s_display_u8,
    d2s_display_u8_plain,
)
from joshupscale_torch.kernels.probes import (
    HALO,
    K,
    PW,
    pair_tail_bound,
    probe_dot,
    probe_dot_bound,
    probe_dot_plain,
    probe_patch_dot,
    probe_patch_dot_bound,
    probe_patch_dot_plain,
    within_bound,
)
from joshupscale_torch.kernels.resblock import (
    resblock_conv3x3,
    resblock_conv3x3_plain,
)
from joshupscale_torch.kernels.warp import warp_s2d
from joshupscale_torch.models.registry import create_models
from joshupscale_torch.ops.warp import (
    dense_image_warp_s2d,
    dense_image_warp_s2d_plain,
)
from joshupscale_torch.runtime.engine import Engine, run_step

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture()
def gen():
    return np.random.default_rng(0)


def _operands(gen, c, dtype, shape, device):
    n, h, w = shape
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        gen.standard_normal(s).astype(np.float32))
    return ((mk(n, h, w, c) * 0.5).to(device, dtype),
            (mk(c, 3, 3, c) / np.sqrt(9 * c)).to(device, dtype),
            (0.5 + torch.from_numpy(gen.random(c).astype(np.float32))).to(
                device),
            (mk(c) * 0.1).to(device),
            mk(n, h, w, c).to(device, dtype))


# (2, 19, 37) cuts across the bf16 kernel's 8 x 16 tiles on both axes,
# (1, 5, 7) is narrower and shorter than one tile, (1, 270, 480) is the
# serving paths' shape (H = 270 is not a multiple of 8): C = 64 on the
# quality and PS2-style tiers, 48 (96-byte rows) on PS2-fast, 32 (the
# dense 64-byte rows) in the fast tier's flow net.  At C = 32, (2, 270,
# 480) gives each CTA 16 tiles through the ring of halos, and
# (3, 131, 250) cuts the tiles on both axes with several tiles a CTA.
_K1_CASES = ([(c, dt, (2, 19, 37)) for c in (32, 48, 64)
              for dt in (torch.bfloat16, torch.float32)]
             + [(c, torch.bfloat16, (1, 5, 7)) for c in (32, 48, 64)]
             + [(c, torch.bfloat16, (1, 270, 480)) for c in (64, 48)]
             + [(32, torch.bfloat16, s)
                for s in ((1, 270, 480), (2, 270, 480), (3, 131, 250))])


@pytest.mark.parametrize("c,dtype,shape", _K1_CASES,
                         ids=[f"{c}-{str(dt)[6:]}-{'x'.join(map(str, s))}"
                              for c, dt, s in _K1_CASES])
def test_resblock_kernel_matches_plain(gen, cuda, c, dtype, shape):
    """Both sum in f32 and round once, in another order: f32 within
    1e-4, bf16 within 1/64 (a few bf16 ulps), relative to 1 + |ref|."""
    tol = 1e-4 if dtype == torch.float32 else 1 / 64
    x, w, s, t, r = _operands(gen, c, dtype, shape, cuda)
    for res, act in ((None, "relu"), (r, "relu"), (r, "lrelu")):
        before = resblock_conv3x3.launches
        got = resblock_conv3x3(x, w, s, t, res, act, 0.3)
        torch.cuda.synchronize()
        assert resblock_conv3x3.launches == before + 1
        ref = resblock_conv3x3_plain(x, w, s, t, res, act, 0.3).float()
        assert bool(((got.float() - ref).abs()
                     <= tol * (1 + ref.abs())).all())


def test_resblock_c32_chain_in_cuda_graph(gen, cuda):
    """A res block at C = 32 (conv_1, then conv_2 with the block's input
    as residual: two launches chained by programmatic dependent launch)
    captured in a CUDA graph and replayed on new inputs: each replay
    equals the eager launches bit for bit, conv_1 is within 1/64 (1 +
    |ref|) of the plain version, and conv_2 of the plain version on
    conv_1's output."""
    bf16 = torch.bfloat16
    x, w1, s1, t1, _ = _operands(gen, 32, bf16, (1, 270, 480), cuda)
    _, w2, s2, t2, _ = _operands(gen, 32, bf16, (1, 8, 8), cuda)

    def block():
        y = resblock_conv3x3(x, w1, s1, t1, None, "relu")
        return y, resblock_conv3x3(y, w2, s2, t2, x, "lrelu", 0.3)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        block()  # warm-up off the capturing stream, as torch asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_graph, z_graph = block()
    for _ in range(2):
        x.copy_(torch.from_numpy(gen.standard_normal(
            tuple(x.shape)).astype(np.float32) * 0.5))
        graph.replay()
        torch.cuda.synchronize()
        y, z = block()
        torch.cuda.synchronize()
        assert torch.equal(y_graph, y) and torch.equal(z_graph, z)
        for got, ref in (
                (y, resblock_conv3x3_plain(x, w1, s1, t1, None, "relu")),
                (z, resblock_conv3x3_plain(y, w2, s2, t2, x, "lrelu", 0.3))):
            ref = ref.float()
            assert bool(((got.float() - ref).abs()
                         <= (1 + ref.abs()) / 64).all())


def _offset(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """A contiguous copy of t whose data starts nbytes past a 16-byte
    boundary."""
    k = nbytes // t.element_size()
    flat = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    out = flat[k:].view(t.shape)
    out.copy_(t)
    return out


def test_resblock_kernel_refuses_bad_operands(gen, cuda):
    x, w, s, t, _ = _operands(gen, 64, torch.bfloat16, (1, 8, 16), cuda)
    with pytest.raises(ValueError):
        resblock_conv3x3(x.transpose(1, 2), w, s, t)  # not contiguous
    with pytest.raises(ValueError):
        resblock_conv3x3(x, w.cpu(), s, t)  # mixed devices
    with pytest.raises(ValueError):
        resblock_conv3x3(_offset(x, 8), w, s, t)  # TMA needs 16-byte bases
    with pytest.raises(ValueError):
        resblock_conv3x3(x, _offset(w, 8), s, t)


@pytest.mark.parametrize("c,dtype", [(64, torch.bfloat16),
                                     (48, torch.bfloat16),
                                     (32, torch.float32)])
def test_registered_ops_match_plain(gen, cuda, c, dtype):
    """``torch.ops.joshupscale.*`` (``csrc/torch_ops.cpp``) called directly
    against the plain versions, with the tolerances of the wrappers'
    tests; a bad operand raises ``ValueError`` in the op itself."""
    from joshupscale_torch.kernels import _build

    ops = _build.ops()
    tol = 1e-4 if dtype == torch.float32 else 1 / 64
    x, w, s, t, r = _operands(gen, c, dtype, (2, 19, 37), cuda)
    for res, act in ((None, 0), (r, 1)):
        got = ops.resblock_conv3x3(x, w, s, t, res, act, 0.3)
        torch.cuda.synchronize()
        ref = resblock_conv3x3_plain(x, w, s, t, res,
                                     ("relu", "lrelu")[act], 0.3).float()
        assert bool(((got.float() - ref).abs()
                     <= tol * (1 + ref.abs())).all())
    z = torch.from_numpy(np.clip(gen.standard_normal(
        (2, 7, 9, 48)).astype(np.float32) * 0.3, -0.5, 0.5)).to(cuda, dtype)
    assert torch.equal(ops.d2s_display_u8(z), d2s_display_u8_plain(z))
    for bad in ((x.transpose(1, 2), w, s, t, None, 0, 0.3),
                (_offset(x, 8), w, s, t, None, 0, 0.3),
                (x, w, s, t, None, 2, 0.3)):
        with pytest.raises(ValueError):
            ops.resblock_conv3x3(*bad)
    with pytest.raises(ValueError):
        ops.d2s_display_u8(_offset(z, 8))


def _warp_inputs(gen, n, h, w, dtype, flow_dtype, motion, device,
                 rows=None):
    """An (n, h, w, 48) s2d image and an (n, rows or h, w, 32) s2d flow.
    ``motion`` "pan": a pan of a few LR pixels plus per-pixel noise (the
    serving traffic's); "edges": uniform flows up to 1.5 frame sizes,
    past every edge (the clamp)."""
    rows = rows or h
    if dtype == torch.uint8:
        image = torch.from_numpy(gen.integers(0, 256, (n, h, w, 48)).astype(
            np.uint8))
    else:
        image = torch.from_numpy((gen.standard_normal(
            (n, h, w, 48)) * 0.25).astype(np.float32)).to(dtype)
    if motion == "pan":
        flow = (gen.standard_normal((n, rows, w, 32)) * 2
                + np.tile(gen.standard_normal(2) * 8, 16))
    else:
        reach = np.tile([h * 4 * 1.5, w * 4 * 1.5], 16)
        flow = (gen.random((n, rows, w, 32)) * 2 - 1) * reach
    return (image.to(device),
            torch.from_numpy(flow.astype(np.float32)).to(device, flow_dtype))


def _warp_matches_plain(image, flow, row0=0):
    """K3 through ``dense_image_warp_s2d`` (one launch) equals the plain
    torch ops on the card, value for value, in the same type."""
    before = warp_s2d.launches
    got = dense_image_warp_s2d(image, flow, row0=row0)
    torch.cuda.synchronize()
    assert warp_s2d.launches == before + 1
    ref = dense_image_warp_s2d_plain(image, flow, 4, row0)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(got, ref), int((got.float() != ref.float()).sum())


_WARP_CASES = [(dt, ft, shape, motion)
               for dt in (torch.bfloat16, torch.float32, torch.uint8)
               for ft in (torch.bfloat16, torch.float32)
               for shape, motion in (((1, 270, 480), "pan"),
                                     ((2, 13, 21), "edges"),
                                     ((2, 270, 480), "edges"))]


@pytest.mark.parametrize(
    "dtype,flow_dtype,shape,motion", _WARP_CASES,
    ids=[f"{str(dt)[6:]}-{str(ft)[6:]}-{'x'.join(map(str, s))}-{m}"
         for dt, ft, s, m in _WARP_CASES])
def test_warp_kernel_equals_plain(gen, cuda, dtype, flow_dtype, shape,
                                  motion):
    """K3 against the plain s2d warp bit for bit: bf16, f32 and u8
    images, bf16 and f32 flows, the serving shape at N = 1 and 2 and an
    odd small one, a pan and flows past every edge."""
    _warp_matches_plain(*_warp_inputs(gen, *shape, dtype, flow_dtype,
                                      motion, cuda))


def test_warp_kernel_on_slabs_and_strided_operands(gen, cuda):
    """K3 on what its callers hand it: ``ps2_style``'s flow cropped from
    the padded grid (strided rows at N = 2, and cropped columns),
    ``SpatialEngine``'s row slabs (``row0``), a flow with a non-unit
    channel stride, a non-contiguous image and a bf16 image that starts
    2 bytes past a 4-byte boundary: bit for bit with the plain ops."""
    bf16 = torch.bfloat16
    image, flow = _warp_inputs(gen, 2, 270, 480, bf16, bf16, "pan", cuda,
                               rows=272)
    cropped = flow[:, 1:271]
    assert not cropped.is_contiguous()
    _warp_matches_plain(image, cropped)
    for a, b in ((0, 100), (100, 170), (170, 270)):
        _warp_matches_plain(image, cropped[:, a:b], row0=a)
    wide, wflow = _warp_inputs(gen, 1, 30, 44, bf16, torch.float32, "edges",
                               cuda)
    padded = torch.nn.functional.pad(wflow, (0, 0, 2, 2, 1, 1))
    _warp_matches_plain(wide, padded[:, 1:31, 2:46])
    _warp_matches_plain(image, cropped.permute(0, 3, 1, 2).contiguous()
                        .permute(0, 2, 3, 1))
    _warp_matches_plain(image.transpose(1, 2).contiguous().transpose(1, 2),
                        cropped)
    _warp_matches_plain(_offset(image, 2), cropped)
    _warp_matches_plain(_warp_inputs(gen, 2, 270, 480, torch.uint8, bf16,
                                     "pan", cuda)[0], cropped)


def test_warp_kernel_refuses_bad_operands(gen, cuda):
    """The op raises on shapes and types it does not take and on mixed
    devices, as ``ValueError`` / ``TypeError``."""
    from joshupscale_torch.kernels import _build

    image, flow = _warp_inputs(gen, 1, 8, 12, torch.bfloat16,
                               torch.bfloat16, "pan", cuda)
    ops = _build.ops()
    for bad in ((image[..., :24], flow, 0), (image, flow[..., :16], 0),
                (image, flow[:, :, :6], 0), (image, flow.cpu(), 0)):
        with pytest.raises(ValueError):
            ops.warp_s2d(*bad)
    with pytest.raises(TypeError):
        ops.warp_s2d(image.half(), flow, 0)


_SHOT_CASES = ("inference_quality", "inference_ps2_style", "u8_state")


@pytest.mark.parametrize("tier", _SHOT_CASES)
def test_engine_with_warp_kernel_equals_plain_warp_over_a_shot(
        gen, cuda, monkeypatch, tier):
    """The OBS quality and PS2-style tiers (their nets at 30 x 44, the
    PS2 flow cropped from its 32 x 48 padded grid) and the u8-state
    option: an engine whose frame graph holds K3 (one launch a frame)
    gives the frames and the state of an engine on the plain warp, bit
    for bit, over a 120-frame shot."""
    from pathlib import Path

    from joshupscale_torch.export.package import load_model_config
    from joshupscale_torch.models import inference

    if tier == "u8_state":
        config = _ps2_config("float32", u8_state=True)
    else:
        config = load_model_config(str(Path(__file__).resolve().parent.parent
                                       / "configs" / f"{tier}.yaml"))
        config["inference"] = dict(config["inference"], frame_height=30,
                                   frame_width=44)
    built = create_models(config, seed=5)["inference"]
    engine = Engine(built.obj, built.params)
    monkeypatch.setattr(inference, "dense_image_warp_s2d",
                        dense_image_warp_s2d_plain)
    plain = Engine(built.obj, built.params)
    assert engine.graph_launches["warp_s2d"] == 1
    assert plain.graph_launches["warp_s2d"] == 0
    m = built.obj
    frames = gen.integers(0, 256, (120, m.frame_height, m.frame_width, 3)
                          ).astype(np.uint8)
    for f in frames:
        np.testing.assert_array_equal(engine.process(f), plain.process(f))
    assert torch.equal(engine.state["pre_gen"], plain.state["pre_gen"])


def test_aoti_artifact_on_card_matches_engine(gen, cuda, tmp_path):
    """A small ``step.pt2`` compiled for the card (``save_package(...,
    export_aoti=True)``, bf16) against ``Engine`` on the card over 4
    recurrent frames, within the card-vs-CPU gate (u8 mean 0.5, 1% off
    by more than 2): inductor fuses the elementwise work around K1 and
    K2 in its own code, so the bytes may differ.  These random, undamped
    weights make large flows, so a wrong flow net shows here (it read a
    library conv's output with the wrong strides until the traced convs
    got contiguous operands: u8 mean 0.75), as ``chip_smoke.py``'s
    flow check does at full width.  Its trace launches the net's K1 and
    K2 by name."""
    from joshupscale_torch.export.package import (
        load_aoti_step,
        save_package,
        state_leaves,
    )

    config = _quality_config("bfloat16")
    built = create_models(config, seed=1)["inference"]
    save_package(str(tmp_path), config, built, export_aoti=True,
                 device=cuda)
    step = load_aoti_step(str(tmp_path))
    engine = Engine(built.obj, built.params)
    state = state_leaves(built.obj.init_state(1, device=cuda))
    frames = gen.integers(0, 256, (4, 24, 40, 3)).astype(np.uint8)
    for i, f in enumerate(frames):
        if i == 3:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                out, *state = step(torch.from_numpy(f[None]).to(cuda),
                                   *state)
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.name.startswith("triton_")]  # inductor's
            assert sum("conv3x3" in n for n in names) == 2 * 4
            assert sum("d2s_display" in n for n in names) == 1
        else:
            out, *state = step(torch.from_numpy(f[None]).to(cuda), *state)
        diff = np.abs(out[0].cpu().numpy().astype(np.int32)
                      - engine.process(f).astype(np.int32))
        assert diff.mean() <= 0.5 and (diff > 2).mean() <= 0.01


def test_aoti_autoencoder_artifact_on_card_matches_engine(gen, cuda,
                                                         tmp_path):
    """The PS2 family as a ``step.pt2`` for the card: the flow
    autoencoder's library convs, max pools and f32 x2 upscales, the
    brightness mean and the pad of 21x38 frames to 24x40 (the
    ``last_frames`` leaf is the padded frame), with random, undamped
    weights (bf16).  Over 4 recurrent frames, each display frame and each
    float state leaf is within the card-vs-CPU gate of ``Engine``'s (u8
    mean 0.5, 1% off by more than 2; the state in u8 steps of its 1/255
    unit: ``_artifact_vs_engine``), and the trace launches the
    generator's 4 K1 and 1 K2 by name."""
    from joshupscale_torch.export.package import save_package

    config = _ps2_config("bfloat16")
    built = create_models(config, seed=2)["inference"]
    save_package(str(tmp_path), config, built, export_aoti=True,
                 device=cuda)
    frames = gen.integers(0, 256, (4, 1, 21, 38, 3)).astype(np.uint8)
    step, args = _artifact_vs_engine(cuda, tmp_path, built, built.params,
                                     frames)
    assert tuple(args[1].shape) == (1, 24, 40, 3)  # padded last frames
    assert _traced_kernels(step, args, (2 * 2, 1)) == (2 * 2, 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_display_kernel_bit_exact(gen, cuda, dtype):
    x = torch.from_numpy(np.clip(
        gen.standard_normal((2, 3, 7, 9, 48)).astype(np.float32) * 0.3,
        -0.5, 0.5)).to(cuda, dtype)
    before = d2s_display_u8.launches
    got = d2s_display_u8(x)
    torch.cuda.synchronize()
    assert d2s_display_u8.launches == before + 1
    assert torch.equal(got, d2s_display_u8_plain(
        x.reshape(6, 7, 9, 48)).reshape(got.shape))


def _bf16(gen, shape, device, scale=1.0):
    return torch.from_numpy(gen.standard_normal(shape).astype(
        np.float32) * scale).to(device, torch.bfloat16)


@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("resident", [True, False],
                         ids=["resident", "streamed"])
@pytest.mark.parametrize("m,k,tile", [(256, 576, 64), (231, 128, 77),
                                      (600, 576, 200)],
                         ids=["small", "odd", "wide"])
def test_probe_dot_kernel_matches_plain(gen, cuda, n, resident, m, k, tile):
    """P1 within one bf16 ulp plus the f32 reorder bound.  The odd shape
    has a ragged last 128-row tile (streamed) and a part-filled 96-row
    block of A_blk (resident); the wide one spreads A_blk over three
    row blocks, the last holding 8 rows."""
    a, b = _bf16(gen, (m, k), cuda), _bf16(gen, (k, n), cuda)
    before = probe_dot.launches
    got = probe_dot(a, b, tile, resident)
    torch.cuda.synchronize()
    assert probe_dot.launches == before + 1
    ref = probe_dot_plain(a, b, tile, resident)
    ok, err = within_bound(got, ref,
                           probe_dot_bound(a, b, tile, resident, ref))
    assert ok, err


@pytest.mark.parametrize("tile,m", [(64, 192), (77, 250), (200, 600),
                                    (256, 768), (2416, 2 * 2416)],
                         ids=["small", "odd", "ragged", "whole", "probe"])
def test_probe_patch_dot_kernel_matches_plain(gen, cuda, tile, m):
    """P2 single within one bf16 ulp plus the reorder bound; the pair
    against the plain pair (two ulps plus the reorder bound) on the rows
    whose first product y1 the kernel rounds as the plain version does,
    at least 90% of them.  250 // 77 truncates to 3 steps.  The kernel
    works in 64-row items: at tile 200 the last item of each step holds
    8 rows, so its store must clip at the step's end; 256 is four whole
    items; 2416 is the probe's own tile (37 whole items and one of 48
    rows), over two steps."""
    x = _bf16(gen, (tile + 2 * HALO + 8, 64), cuda)
    w1, w2 = (_bf16(gen, (K, 64), cuda, 0.05) for _ in range(2))
    before = probe_patch_dot.launches
    y1 = probe_patch_dot(x, w1, w2, tile, False, m=m)
    pair = probe_patch_dot(x, w1, w2, tile, True, m=m)
    torch.cuda.synchronize()
    assert probe_patch_dot.launches == before + 2
    assert y1.shape == pair.shape == ((m // tile) * tile, 64)
    ref = probe_patch_dot_plain(x, w1, w2, tile, False, m=m)
    ok, err = within_bound(y1, ref,
                           probe_patch_dot_bound(x, w1, tile, ref, m=m))
    assert ok, err
    pair_ref = probe_patch_dot_plain(x, w1, w2, tile, True, m=m)
    same = (y1 == ref).all(dim=1)
    assert float(same.float().mean()) >= 0.9
    ok, err = within_bound(pair[same], pair_ref[same], pair_tail_bound(
        ref[:tile], x, w2, pair_ref)[same])
    assert ok, err


def test_probe_kernels_refuse_bad_operands(gen, cuda):
    a, b = _bf16(gen, (256, K), cuda), _bf16(gen, (K, 64), cuda)
    flat = torch.empty(256 * K + 8, dtype=torch.bfloat16, device=cuda)
    misaligned = flat[1:1 + 256 * K].view(256, K)
    with pytest.raises(ValueError):
        probe_dot(misaligned, b, 64)  # contiguous, 2 bytes off
    with pytest.raises(ValueError):
        probe_dot(_offset(a, 8), b, 64)  # TMA needs 16-byte bases
    with pytest.raises(ValueError):
        probe_dot(a, _offset(b, 8), 64, resident=False)
    with pytest.raises(ValueError):
        probe_dot(_bf16(gen, (K, 256), cuda).t(), b, 64)  # not contiguous
    with pytest.raises(ValueError):
        probe_dot(a, b.cpu(), 64)  # mixed devices
    x = _bf16(gen, (64 + HALO + PW + 1, 64), cuda)
    with pytest.raises(ValueError):
        probe_patch_dot(x[:, :32], b, b, 64, m=64)
    with pytest.raises(ValueError):
        probe_patch_dot(x[:-1], b, b, 64, True, m=64)  # too few rows
    with pytest.raises(ValueError):
        probe_patch_dot(_offset(x, 8), b, b, 64, m=64)  # TMA: 16-byte bases


def _quality_config(compute_dtype):
    return {
        "flow": {"name": "flow-resnet", "num_filters": 32,
                 "num_res_blocks": 2},
        "generator": {"name": "generator-resnet", "num_filters": 48,
                      "num_res_blocks": 2},
        "inference": {"name": "inference", "flow": {"model": "flow"},
                      "generator": {"model": "generator"},
                      "skip_processing": False, "frame_height": 24,
                      "frame_width": 40, "compute_dtype": compute_dtype},
    }


def _graph_launches(k1, k2, k3):
    return {"resblock_conv3x3": k1, "d2s_display_u8": k2, "probe_dot": 0,
            "probe_patch_dot": 0, "warp_s2d": k3}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_engine_cuda_matches_cpu(gen, cuda, compute_dtype):
    """The engine on the card vs on the CPU (plain versions), 4 frames:
    u8 within 1 step in f32; in bf16 within 2 steps (roundings at other
    places in the library convs and products).  The card's frames are
    replays of one graph holding the 4 res blocks' 8 K1 launches and
    K2, so no wrapper is called while serving."""
    built = create_models(_quality_config(compute_dtype),
                          seed=1)["inference"]
    on_card = Engine(built.obj, built.params)
    on_cpu = Engine(built.obj, built.params, device="cpu")
    assert on_card.graph_launches == _graph_launches(2 * 4, 1, 1)
    frames = gen.integers(0, 256, (4, 24, 40, 3)).astype(np.uint8)
    before = resblock_conv3x3.launches, d2s_display_u8.launches
    for f in frames:
        diff = np.abs(on_card.process(f).astype(np.int32)
                      - on_cpu.process(f).astype(np.int32))
        assert diff.max() <= (1 if compute_dtype == "float32" else 2)
    assert (resblock_conv3x3.launches, d2s_display_u8.launches) == before


def _ps2_config(compute_dtype, **options):
    config = {
        "flow": {"name": "flow-autoencoder", "num_inputs": 4,
                 "filters": [16, 32, 64, 32, 16]},
        "generator": {"name": "generator-resnet", "num_filters": 48,
                      "num_res_blocks": 2},
        "inference": {"name": "inference", "flow": {"model": "flow"},
                      "generator": {"model": "generator"},
                      "skip_processing": False, "frame_height": 21,
                      "frame_width": 38, "compute_dtype": compute_dtype,
                      "flow_pad_factor": 8, "normalize_brightness": True,
                      **options},
    }
    if options.get("remove_flow"):
        del config["flow"], config["inference"]["flow"]
    return config


_OPTIONS = {
    "ps2": {}, "u8_state": {"u8_state": True},
    "moving_avg": {"frame_moving_avg": {"strength": 0.7,
                                        "threshold": 0.1}},
    "moving_avg_window": {"frame_moving_avg": {"strength": 0.7,
                                               "threshold": 0.1,
                                               "window": 8}},
    "output_flow": {"output_flow": True}, "remove_flow": {"remove_flow": True},
    "pixel_mode": {"s2d_mode": False},
}
_OPTION_CASES = [(o, "float32") for o in _OPTIONS] + [("ps2", "bfloat16")]


@pytest.mark.parametrize("option,compute_dtype", _OPTION_CASES)
def test_serving_option_cuda_matches_cpu(gen, cuda, option, compute_dtype):
    """The PS2 configuration (autoencoder, 21x38 padded to 24x40,
    brightness) and each serving option on it, on the card vs on the
    CPU, 4 frames: u8 within 1 step in f32, 2 in bf16, as the quality
    tier's test.  The frame graph holds K1 2 a res block except under
    output_flow, and K2 on the deferred s2d paths only."""
    built = create_models(_ps2_config(compute_dtype, **_OPTIONS[option]),
                          seed=3)["inference"]
    on_card = Engine(built.obj, built.params)
    on_cpu = Engine(built.obj, built.params, device="cpu")
    frames = gen.integers(0, 256, (4, 21, 38, 3)).astype(np.uint8)
    before = resblock_conv3x3.launches, d2s_display_u8.launches
    for f in frames:
        diff = np.abs(on_card.process(f).astype(np.int32)
                      - on_cpu.process(f).astype(np.int32))
        assert diff.max() <= (1 if compute_dtype == "float32" else 2)
    deferred = option not in ("remove_flow", "pixel_mode")
    assert on_card._deferred == deferred
    # K3, the s2d warp, runs on the same paths as the deferred display:
    # s2d mode with a flow net.
    assert on_card.graph_launches == _graph_launches(
        0 if option == "output_flow" else 2 * 2, int(deferred),
        int(deferred))
    assert (resblock_conv3x3.launches, d2s_display_u8.launches) == before


_REPLAY_CASES = ([("quality", None, dt) for dt in ("float32", "bfloat16")]
                 + [("ps2", o, dt) for o, dt in _OPTION_CASES])


@pytest.mark.parametrize("arch,option,compute_dtype", _REPLAY_CASES)
def test_replayed_frames_equal_eager_steps(gen, cuda, arch, option,
                                           compute_dtype):
    """The graph's frames equal eager ``run_step`` + display on a copy
    of the state bit for bit, and so do the states, over 6 frames with a
    ``reset()`` after the third: the warm-up before the capture left the
    state at ``init_state``, the shift register follows, and reset
    reaches the graph's buffers."""
    config = (_quality_config(compute_dtype) if arch == "quality"
              else _ps2_config(compute_dtype, **_OPTIONS[option]))
    built = create_models(config, seed=4)["inference"]
    engine = Engine(built.obj, built.params)
    model = engine.model
    h, w = model.frame_height, model.frame_width
    frames = gen.integers(0, 256, (6, h, w, 3)).astype(np.uint8)
    state = model.init_state(device=cuda)
    for i, f in enumerate(frames):
        if i == 3:
            engine.reset()
            state = model.init_state(device=cuda)
        got = engine.process(f)
        with torch.inference_mode():
            x = torch.from_numpy(f[None]).to(cuda)
            ref = engine.display(run_step(model, engine.params, x, state))
        np.testing.assert_array_equal(got, ref.cpu().numpy()[0])
        if state:
            for a, b in zip([engine.state["pre_gen"]]
                            + engine.state["last_frames"],
                            [state["pre_gen"]] + state["last_frames"]):
                assert torch.equal(a, b)


def test_process_clip_and_async_on_card(gen, cuda):
    """``process_clip`` copies each frame out of the graph's buffer
    before the next replay, and ``process_async`` returns each frame's
    own tensor: both equal streamed ``process`` on the card."""
    built = create_models(_quality_config("bfloat16"), seed=5)["inference"]
    frames = gen.integers(0, 256, (5, 24, 40, 3)).astype(np.uint8)
    streamed = Engine(built.obj, built.params)
    ref = np.stack([streamed.process(f) for f in frames])
    engine = Engine(built.obj, built.params, max_inflight=2)
    np.testing.assert_array_equal(engine.process_clip(frames), ref)
    engine.reset()
    np.testing.assert_array_equal(
        engine.process_clip(frames[:, None], chunk_frames=2)[:, 0], ref)
    engine.reset()
    outs = []
    for f in frames:
        outs.append(engine.process_async(f))
        assert len(engine._pending) <= 2
    np.testing.assert_array_equal(
        np.stack([o.cpu().numpy()[0] for o in outs]), ref)


def test_engine_step_does_not_sync(gen, cuda):
    """A step (a copy into the graph's input buffer and a replay) and a
    display enqueue their work and return: no host<->device copy or
    other synchronising call inside them (every constant is built when
    the engine is)."""
    config = {
        "flow": {"name": "flow-resnet", "num_filters": 32,
                 "num_res_blocks": 1},
        "generator": {"name": "generator-resnet", "num_filters": 32,
                      "num_res_blocks": 1},
        "inference": {"name": "inference", "flow": {"model": "flow"},
                      "generator": {"model": "generator"},
                      "skip_processing": False, "frame_height": 16,
                      "frame_width": 24, "compute_dtype": "bfloat16"},
    }
    built = create_models(config, seed=2)["inference"]
    engine = Engine(built.obj, built.params)
    frame = torch.from_numpy(
        gen.integers(0, 256, (1, 16, 24, 3)).astype(np.uint8)).to(cuda)
    engine.display(engine.step(frame))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine.display(engine.step(frame))
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("m,k,n", [(129600, 576, 64), (129600, 504, 64),
                                   (2040, 2304, 256), (10, 64, 32)])
def test_int8_product_exact_on_card(cuda, m, k, n):
    """The int8 conv's product (``nn.layers._int_mm``) on the card at the
    main path's shapes (a full frame at C = 64, the generator's first
    conv at K = 9 x 56, the autoencoder's 256-channel conv at K = 2304,
    whose sums pass 2^24) and a short one (M <= 16 gets zero rows):
    equal to the CPU's int32 product."""
    from joshupscale_torch.nn.layers import _int_mm

    g = torch.Generator().manual_seed(m + k)
    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=g)
    b = torch.randint(-127, 128, (n, k), dtype=torch.int8, generator=g)
    want = _int_mm(a, b.t())
    got = _int_mm(a.to(cuda), b.to(cuda).t())
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)


def _int8_params(built, frames=None, device=None):
    from joshupscale_torch.export.quantize import (
        calibrate,
        quantize_params_int8,
    )

    ranges = None
    if frames is not None:
        ranges = calibrate(built.obj, built.params, frames[:, None],
                           device=device)
    return quantize_params_int8(built.params, ranges=ranges)


_INT8_CASES = [("quality", False), ("quality", True), ("ps2", False)]


@pytest.mark.parametrize("arch,calibrated", _INT8_CASES)
def test_int8_engine_on_card(gen, cuda, arch, calibrated):
    """The int8 tier through the engine on the card: every res block
    quantized (0 K1, 1 K2 in the frame graph), a step makes no
    synchronising call, replays equal eager steps bit for bit across a
    ``reset()``, and the frames stay within 2 u8 steps of the CPU's
    (bf16 rounded at other places upstream of a conv can move one
    quantization level)."""
    config = (_quality_config("bfloat16") if arch == "quality"
              else _ps2_config("bfloat16"))
    built = create_models(config, seed=6)["inference"]
    h, w = built.obj.frame_height, built.obj.frame_width
    frames = gen.integers(0, 256, (6, h, w, 3)).astype(np.uint8)
    params = _int8_params(built, frames[:3] if calibrated else None, cuda)
    engine = Engine(built.obj, params)
    assert engine.graph_launches == _graph_launches(0, 1, 1)
    on_cpu = Engine(built.obj, params, device="cpu")
    model = engine.model
    state = model.init_state(device=cuda)
    for i, f in enumerate(frames):
        if i == 3:
            engine.reset()
            on_cpu.reset()
            state = model.init_state(device=cuda)
        got = engine.process(f)
        assert np.abs(got.astype(np.int32)
                      - on_cpu.process(f).astype(np.int32)).max() <= 2
        with torch.inference_mode():
            x = torch.from_numpy(f[None]).to(cuda)
            ref = engine.display(run_step(model, engine.params, x, state))
        np.testing.assert_array_equal(got, ref.cpu().numpy()[0])
    x = torch.from_numpy(frames[0][None]).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine.display(engine.step(x))
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_compiled_quantization_rounds_as_eager(cuda):
    """The int8 tier's quantization (``x / act_scale`` in float32, rounded
    half to even) compiled by inductor with the serving step's settings
    (``export.package.inductor_options``) gives eager's levels on
    quotients at and beside the ties: Triton's default division is
    approximate and moved about 3% of these (H100, torch 2.11)."""
    from joshupscale_torch.export.package import inductor_options

    g = torch.Generator().manual_seed(0)
    s = torch.tensor([0.0123456789])
    base = (torch.randint(-127, 127, (1 << 20,), generator=g) + 0.5) * s
    x = torch.cat([base, torch.nextafter(base, base + 1),
                   torch.nextafter(base, base - 1)]).to(cuda)
    s = s.to(cuda)

    def quantize(x, s):
        return torch.div(x, s.reshape(1)).round_()

    torch._dynamo.reset()
    with torch._inductor.config.patch(inductor_options()):
        got = torch.compile(quantize)(x, s)
    assert torch.equal(got, quantize(x, s))


def _gate(got, ref, scale=1.0):
    """The card-vs-CPU gate on a frame or a state leaf, in u8 steps
    (``scale`` 255 for a float tensor in the nets' unit): mean 0.5, 1% of
    the values off by more than 2."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    d *= scale
    return d.mean() <= 0.5 and (d > 2).mean() <= 0.01, float(d.mean())


def _artifact_vs_engine(cuda, path, built, params, frames, batch_size=1):
    """``load_aoti_step`` of the package at ``path`` over recurrent
    ``frames`` (each (N, H, W, 3)) against ``Engine(batch_size)`` on
    ``params``, both on the card: every display frame and every float
    state leaf after every frame within the card-vs-CPU gate (a float
    display, ``skip_processing``'s HR frame, and the state in u8 steps
    of their 1/255 unit).  Returns the step and its last call's inputs."""
    from joshupscale_torch.export.package import load_aoti_step, state_leaves

    step = load_aoti_step(str(path))
    engine = Engine(built.obj, params, device=cuda, batch_size=batch_size)
    state = state_leaves(built.obj.init_state(batch_size, device=cuda))
    skip = built.obj.skip_processing
    for i, f in enumerate(frames):
        x = f.astype(np.float32) / 255 - 0.5 if skip else f
        args = (torch.from_numpy(x).to(cuda), *state)
        out, *state = step(*args)
        ok, mean = _gate(out.float().cpu().numpy(), engine.process(x),
                         255.0 if skip else 1.0)
        assert ok, (i, mean)
        for leaf, ref in zip(state, state_leaves(engine.state)):
            if leaf.is_floating_point():
                ok, mean = _gate(leaf.float().cpu().numpy(),
                                 ref.float().cpu().numpy(), 255.0)
                assert ok, (i, tuple(leaf.shape), mean)
    return step, args


def _traced_kernels(step, args, expected):
    """K1 and K2 launches of one call ``step(*args)``, counted by kernel
    name in a profiler trace (inductor's fused kernels left out).  A
    session that counts fewer than ``expected`` runs again, up to 3: a
    session can lose kernel records (ROADMAP section 3); one that counts
    more is returned at once."""
    for _ in range(3):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            step(*args)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.name.startswith("triton_")]
        got = (sum("conv3x3" in n for n in names),
               sum("d2s_display" in n for n in names))
        if got == expected or any(g > e for g, e in zip(got, expected)):
            break
    return got


# Each serving option's artifact: (options, batch size), on the PS2
# configuration in f32 (its bf16 artifact is the autoencoder test's).
# skip_processing (float I/O) and batch 2 are served by load_aoti_step
# only: the host takes u8-I/O, batch-1 sets.
_ARTIFACT_CASES = {**{o: (opts, 1) for o, opts in _OPTIONS.items()},
                   "skip_processing": ({"skip_processing": True}, 1),
                   "batch_2": ({}, 2)}


@pytest.mark.parametrize("option", list(_ARTIFACT_CASES))
def test_option_artifact_on_card_matches_engine(gen, cuda, tmp_path,
                                                option):
    """Each serving option's ``step.pt2`` compiled for the card
    (``save_package(..., export_aoti=True)``, f32, 21x38 frames of the
    PS2 configuration, random undamped weights) against ``Engine`` on the
    card over 4 recurrent frames: display frames and float state within
    the card-vs-CPU gate.  A traced run of the last frame launches K1 2
    a res block but under output_flow, and K2 on the deferred s2d paths
    only, as the frame graph does."""
    from joshupscale_torch.export.package import save_package

    options, batch = _ARTIFACT_CASES[option]
    config = _ps2_config("float32", **options)
    built = create_models(config, seed=8)["inference"]
    save_package(str(tmp_path), config, built, batch_size=batch,
                 export_aoti=True, device=cuda)
    frames = gen.integers(0, 256, (4, batch, 21, 38, 3)).astype(np.uint8)
    step, args = _artifact_vs_engine(cuda, tmp_path, built, built.params,
                                     frames, batch)
    deferred = option not in ("remove_flow", "pixel_mode",
                              "skip_processing")
    expected = (0 if option == "output_flow" else 2 * 2, int(deferred))
    assert _traced_kernels(step, args, expected) == expected


@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["dynamic", "calibrated"])
def test_int8_artifact_on_card_matches_engine(gen, cuda, tmp_path,
                                              calibrated):
    """The int8 tier as a ``step.pt2`` compiled for the card (the PS2
    configuration in bf16, with dynamic scales and with ranges from
    ``calibrate`` on the card): its graph holds one ``aten._int_mm`` a
    quantized conv; over 4 recurrent frames its display frames and float
    state are within the card-vs-CPU gate of the int8 ``Engine``'s on the
    card; its trace launches 0 K1 (every res block quantized) and 1 K2.
    The autoencoder's first conv is too small to quantize, so a library
    conv feeds the next, int8 one: both cases failed to lower before
    ``nn.layers.row_major`` held the padded input row-major."""
    from joshupscale_torch.export.package import save_package
    from joshupscale_torch.export.quantize import quantized_convs

    config = _ps2_config("bfloat16")
    built = create_models(config, seed=9)["inference"]
    h, w = built.obj.frame_height, built.obj.frame_width
    frames = gen.integers(0, 256, (4, 1, h, w, 3)).astype(np.uint8)
    params = _int8_params(built, frames[:3, 0] if calibrated else None,
                          cuda)
    built.params = params
    program = save_package(str(tmp_path), config, built, export_aoti=True,
                           device=cuda)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("aten._int_mm.default") == quantized_convs(params)
    step, args = _artifact_vs_engine(cuda, tmp_path, built, params, frames)
    assert _traced_kernels(step, args, (0, 1)) == (0, 1)


def test_sharded_and_pipelined_engines_on_card(gen, cuda):
    """On one card: ``ShardedEngine(devices=['cuda:0'],
    streams_per_device=2)`` equals ``Engine(batch_size=2)`` bit for bit
    (one engine of two streams, K1 at N = 2), and ``PipelinedEngine`` on
    ('cuda:0', 'cuda:0') -- two frame graphs and the payload copy --
    equals ``Engine`` bit for bit, streamed, as a clip and async."""
    from joshupscale_torch.parallel import PipelinedEngine, ShardedEngine

    built = create_models(_quality_config("bfloat16"), seed=7)["inference"]
    frames = gen.integers(0, 256, (4, 2, 24, 40, 3)).astype(np.uint8)
    sharded = ShardedEngine(built.obj, built.params, devices=["cuda:0"],
                            streams_per_device=2)
    batched = Engine(built.obj, built.params, batch_size=2)
    assert batched.graph_launches == _graph_launches(2 * 4, 1, 1)
    for f in frames:
        np.testing.assert_array_equal(sharded.process(f), batched.process(f))
    piped = PipelinedEngine(built.obj, built.params,
                            devices=("cuda:0", "cuda:0"))
    single = Engine(built.obj, built.params)
    want = np.stack([single.process(f) for f in frames[:, 0]])
    np.testing.assert_array_equal(
        np.stack([piped.process(f) for f in frames[:, 0]]), want)
    piped.reset()
    np.testing.assert_array_equal(piped.process_clip(frames[:, 0]), want)
    piped.reset()
    outs = [piped.process_async(f) for f in frames[:, 0]]
    np.testing.assert_array_equal(
        np.stack([o.cpu().numpy()[0] for o in outs]), want)


# ---------------------------------------------------------------------------
# FRVSR training on the card (no kernel of the port: library convs under
# autograd, the s2d warp's backward in plain PyTorch)


def _train_setup(device, compute_dtype="float32", filters=16):
    from joshupscale_torch.training import init_train_state, make_optimizer

    config = {
        "flow": {"name": "flow-resnet", "num_inputs": 4,
                 "num_filters": filters, "num_res_blocks": 1},
        "generator": {"name": "generator-resnet", "num_filters": filters,
                      "num_res_blocks": 2},
        "frvsr": {"name": "frvsr", "flow": {"model": "flow"},
                  "generator": {"model": "generator"},
                  "compute_dtype": compute_dtype},
    }
    built = create_models(config)["frvsr"]
    opt = make_optimizer(1e-3)
    return built, opt, init_train_state(built.params, opt, device)


def _train_batch(gen, device, b=2, t=4, crop=8):
    batch = {"input": gen.integers(0, 256, (b, t, crop, crop, 3),
                                   dtype=np.uint8),
             "target": gen.integers(0, 256, (b, t, 4 * crop, 4 * crop, 3),
                                    dtype=np.uint8)}
    batch["input"][:, :, :2] = 255
    batch["target"][:, :, -4:] = 0
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def test_frvsr_step_on_card_matches_cpu(gen, cuda):
    """One float32 step's loss and gradients on the card against the
    CPU (TF32 off in the step): loss within 1e-5 relative, each
    gradient within 1e-4 relative L2 error."""
    from joshupscale_torch.training import init_train_state
    from joshupscale_torch.training.trainer import (
        exact_float32,
        loss_and_grads,
    )

    built, opt, _ = _train_setup(cuda)
    batch = _train_batch(gen, "cpu")
    noise = built.obj.draw_noise(batch["input"].shape,
                                 torch.Generator().manual_seed(0), "cpu")
    out = []
    for dev in (cuda, torch.device("cpu")):
        params = init_train_state(built.params, opt, dev).params
        with exact_float32():
            loss, _, grads = loss_and_grads(
                built.obj, params, {k: v.to(dev) for k, v in batch.items()},
                {k: v.to(dev) for k, v in noise.items()})
        out.append((loss.item(), {p: g.cpu() for p, g in grads.items()}))
    (l_card, g_card), (l_cpu, g_cpu) = out
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    for p, ref in g_cpu.items():
        err = float((g_card[p] - ref).norm() / ref.norm().clamp_min(1e-30))
        assert err <= 1e-4, (p, err)


def test_s2d_warp_backward_on_card_matches_cpu_bf16(gen, cuda):
    """The training warp through the s2d table in bf16.  The image's
    gradient is summed in float32 by atomic adds on the card (the order
    changes from run to run) and rounded once to bf16, so it is within
    one bf16 step (2^-7 relative) of the CPU's everywhere, also where a
    far flow sends every query of a region to one edge block (hundreds
    of adds into its rows; a bf16 sum would round each).  The output and
    the flow's gradient are elementwise: within 1% relative L2."""
    from joshupscale_torch.ops.warp import dense_image_warp_via_s2d

    image = torch.from_numpy(gen.standard_normal((2, 32, 48, 3)).astype(
        np.float32) * 0.3)
    flow = (gen.standard_normal((2, 32, 48, 2)) * 3).astype(np.float32)
    flow[:, 16:] = 60.0
    flow = torch.from_numpy(flow)
    cot = torch.from_numpy(gen.standard_normal((2, 32, 48, 3)).astype(
        np.float32))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        img = image.to(dev, torch.bfloat16).requires_grad_()
        fl = flow.to(dev, torch.bfloat16).requires_grad_()
        out = dense_image_warp_via_s2d(img, fl)
        (out.float() * cot.to(dev)).sum().backward()
        assert img.grad.dtype == torch.bfloat16
        grads.append((out.float().cpu(), fl.grad.float().cpu(),
                      img.grad.float().cpu()))
    (out, g_flow, g_img), (out_ref, g_flow_ref, g_img_ref) = grads
    for got, ref in ((out, out_ref), (g_flow, g_flow_ref)):
        assert float((got - ref).norm() / ref.norm()) < 1e-2
    assert bool(((g_img - g_img_ref).abs()
                 <= 2 ** -7 * g_img_ref.abs() + 1e-6).all())


def test_bf16_training_loss_falls(gen, cuda):
    """Four bf16 steps on one batch: finite losses that fall, moving
    statistics updated, params and moments float32."""
    from joshupscale_torch.training import build_frvsr_step

    built, opt, state = _train_setup(cuda, "bfloat16")
    step = build_frvsr_step(built.obj, opt)
    batch = _train_batch(gen, cuda)
    rng = torch.Generator(cuda).manual_seed(0)
    losses = []
    for _ in range(4):
        noise = built.obj.draw_noise(batch["input"].shape,
                                     torch.Generator(cuda).manual_seed(1),
                                     cuda)
        state, metrics = step(state, batch, rng=rng, noise=noise)
        losses.append(metrics["loss"].item())
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert state.step == 4
    bn = state.params["flow"]["bn_1"]
    assert bn["moving_mean"].abs().max() > 0
    assert state.params["generator"]["conv_1"]["kernel"].dtype == \
        torch.float32
    assert state.opt_state["mu"]["generator"]["conv_1"]["kernel"].dtype == \
        torch.float32


def _gan_setup(filters=16):
    config = {
        "flow": {"name": "flow-resnet", "num_inputs": 4,
                 "num_filters": filters, "num_res_blocks": 1},
        "generator": {"name": "generator-resnet", "num_filters": filters,
                      "num_res_blocks": 1},
        "discriminator": {"name": "discriminator", "alpha": 0.25},
        "vgg": {"name": "vgg"},
        "gan": {"name": "gan", "flow": {"model": "flow"},
                "generator": {"model": "generator"},
                "discriminator": {"model": "discriminator"},
                "vgg": {"model": "vgg"}},
    }
    built = create_models(config)["gan"]
    # Heads damped, as a trained generator's residual is small beside its
    # bilinear skip: with glorot heads the 19-step recurrence amplifies
    # round-off (tests/test_torch_gan.py).
    built.params["gen"]["flow"]["conv_2"]["kernel"].mul_(0.3)
    built.params["gen"]["generator"]["conv_trans_2"]["kernel"].mul_(0.3)
    return built


def _gan_grads(built, batch, noise, dev, nudge=1.0):
    from joshupscale_torch.training import init_gan_state, make_optimizer
    from joshupscale_torch.training.trainer import (
        exact_float32,
        gan_gradients,
        gan_losses,
        to_device,
    )

    opt = make_optimizer(1e-3)
    state = init_gan_state(built.obj, built.params["gen"],
                           built.params["discr"], opt, opt, dev)
    with torch.no_grad():
        for net in ("flow", "generator"):
            state.gen_params[net]["conv_1"]["kernel"].mul_(nudge)
    with exact_float32():
        terms, _ = gan_losses(built.obj, state,
                              {k: v.to(dev) for k, v in batch.items()},
                              {k: v.to(dev) for k, v in noise.items()},
                              to_device(built.params["vgg"], dev))
        grads = gan_gradients(terms, state)
    return ({k: v.item() for k, v in terms.items()},
            [{p: g.cpu() for p, g in group.items()} for group in grads])


def test_gan_step_on_card_matches_cpu(gen, cuda):
    """The GAN step's forward and both gradient pulls in float32 (TF32
    off) on the card against the CPU: each loss term within 1e-5
    relative (the VGG loss, 1 - cos of near-parallel features, 1e-4);
    each gradient within 1e-4 relative L2, or 3x the CPU's own largest
    change under three nudges of the first convs' kernels by ~1e-7
    where that is larger (the warp's gradient in the flow jumps where a
    flow crosses an integer); then a whole step on each: the
    same gate decision and ``discr_steps``."""
    from joshupscale_torch.training import (
        build_gan_step,
        init_gan_state,
        make_optimizer,
    )

    built = _gan_setup()
    batch = {k: v for k, v in _train_batch(gen, "cpu", t=10).items()}
    noise = built.obj.draw_noise(batch["input"].shape,
                                 torch.Generator().manual_seed(0), "cpu")
    t_card, g_card = _gan_grads(built, batch, noise, cuda)
    t_cpu, g_cpu = _gan_grads(built, batch, noise, torch.device("cpu"))
    nudges = [_gan_grads(built, batch, noise, torch.device("cpu"), n)[1]
              for n in (1 + 1e-7, 1 - 1e-7, 1 + 2e-7)]
    for name, v in t_cpu.items():
        rtol = 1e-4 if name == "vgg_loss" else 1e-5
        assert abs(t_card[name] - v) <= rtol * abs(v) + 1e-7, name

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    for i, (card, cpu) in enumerate(zip(g_card, g_cpu)):
        self_err = max(rel(n[i][p], g) for n in nudges
                       for p, g in cpu.items() if g.abs().max() > 0)
        bound = max(1e-4, 3 * self_err)
        for p, ref in cpu.items():
            assert rel(card[p], ref) <= bound, (p, rel(card[p], ref), bound)
    out = []
    for dev in (cuda, torch.device("cpu")):
        gopt, dopt = make_optimizer(1e-3), make_optimizer(1e-3)
        state = init_gan_state(built.obj, built.params["gen"],
                               built.params["discr"], gopt, dopt, dev)
        step = build_gan_step(built.obj, gopt, dopt, built.params["vgg"])
        state, metrics = step(state, {k: v.to(dev) for k, v in
                                      batch.items()},
                              noise={k: v.to(dev) for k, v in
                                     noise.items()})
        out.append((state.ema["discr_steps"], state.discr_opt_state["count"],
                    metrics["t_balance1_avg"].item()))
    assert out[0][:2] == out[1][:2] == (1, 1)
    assert abs(out[0][2] - out[1][2]) <= 1e-5 * abs(out[1][2]) + 1e-9


def test_play_prediction_on_card_runs_k1_f32(gen, cuda):
    """``predict_sequence`` of a float32 inference model (32 filters, one
    res block per net) on an 8x8 play clip: K1 launches on the card (2
    per res block, 18 steps) in float32, the prediction within 1e-4 of
    the CPU's (K1's plain version there)."""
    from joshupscale_torch.kernels.resblock import resblock_conv3x3
    from joshupscale_torch.training.play import build_strips, predict_sequence

    config = {
        "flow": {"name": "flow-resnet", "num_inputs": 4, "num_filters": 32,
                 "num_res_blocks": 1},
        "generator": {"name": "generator-resnet", "num_filters": 32,
                      "num_res_blocks": 1},
        "inference": {"name": "inference", "flow": {"model": "flow"},
                      "generator": {"model": "generator"},
                      "skip_processing": True, "frame_height": 8,
                      "frame_width": 8},
    }
    built = create_models(config)["inference"]
    batch = _train_batch(gen, "cpu", t=10)
    inputs = batch["input"].float() / 255 - 0.5
    targets = batch["target"].float() / 255 - 0.5
    before = resblock_conv3x3.launches
    got = predict_sequence(built.obj, built.params, inputs.to(cuda),
                           targets.to(cuda))
    torch.cuda.synchronize()
    assert resblock_conv3x3.launches - before == 2 * 2 * 18
    ref = predict_sequence(built.obj, built.params, inputs, targets)
    for k, v in ref.items():
        assert float((got[k].cpu() - v).abs().max()) <= 1e-4, k
    strips = build_strips(got, targets)
    assert strips["comparison"].shape == (2, 18, 32, 96, 3)


def test_onnx_graph_runner_on_card_matches_cpu(gen, cuda, tmp_path):
    """``run_graph_torch`` on the card against the CPU on one frame of the
    exported graph (32 filters, 16x24, BN statistics perturbed), the
    float32 and the fp16 graph.  Bounds, set from the dtypes: float32
    (TF32 off) 5e-3 on the [0, 255] output and 2e-5 on the [-0.5, 0.5]
    states; fp16 storage two f16 ulps (0.25 at 255, 1e-3 at 0.5)."""
    from joshupscale_torch.export.onnx_export import export_onnx
    from joshupscale_torch.export.onnx_interp import model_float_dtype
    from joshupscale_torch.export.onnx_minimal import decode_model
    from joshupscale_torch.export.onnx_torch import run_graph_torch

    h, w = 16, 24
    config = {
        "flow": {"name": "flow-resnet", "num_inputs": 4, "num_filters": 32,
                 "num_res_blocks": 2},
        "generator": {"name": "generator-resnet", "num_filters": 32,
                      "num_res_blocks": 2},
        "inference": {"name": "inference", "flow": {"model": "flow"},
                      "generator": {"model": "generator"},
                      "skip_processing": False, "frame_height": h,
                      "frame_width": w},
    }
    params = create_models(config, seed=2)["inference"].params
    for net in params.values():
        for blk in net.values():
            for bn in (blk.get("bn_1"), blk.get("bn_2")):
                if bn is not None:
                    bn["moving_variance"] = torch.from_numpy(
                        (1 + gen.random(32)).astype(np.float32))
    for fp16, (tol_out, tol_state) in ((False, (5e-3, 2e-5)),
                                       (True, (0.25, 1e-3))):
        path = str(tmp_path / f"m{int(fp16)}.onnx")
        export_onnx(path, params, h, w, fp16=fp16)
        model = decode_model(open(path, "rb").read())
        dt = model_float_dtype(model)
        feeds = {"cur_frame": gen.integers(0, 256, (1, h, w, 3)).astype(dt),
                 "pre_gen": gen.uniform(-0.5, 0.5, (1, 3, 4 * h, 4 * w))
                 .astype(dt),
                 **{f"last_frame_{i}": gen.uniform(-0.5, 0.5, (1, 3, h, w))
                    .astype(dt) for i in range(3)}}
        got = run_graph_torch(model, feeds)
        ref = run_graph_torch(model, feeds, device="cpu")
        for k, v in ref.items():
            assert got[k].dtype == v.dtype == dt, k
            tol = tol_out if k == "output" else tol_state
            diff = np.abs(got[k].astype(np.float32) - v.astype(np.float32))
            assert float(diff.max()) <= tol, (fp16, k, float(diff.max()))


def test_two_worker_loader_under_a_cuda_context(cuda, tmp_path):
    """``create_train_dataset(num_workers=2)`` from a parent that holds a
    CUDA context (spawned workers, the card hidden from them) over a
    TFRecord pair chain: the in-process shards' batches, round robin,
    bit for bit; no ``/dev/shm`` segment left after an early close."""
    import os

    import cv2

    from joshupscale_torch.data import tfrecord
    from joshupscale_torch.data.pipeline import (
        create_dataset,
        create_train_dataset,
    )

    torch.zeros(1, device=cuda)
    assert torch.cuda.is_initialized()
    rng = np.random.default_rng(4)
    path = str(tmp_path / "pairs.tfrecords")
    png = lambda f: cv2.imencode(".png", f)[1].tobytes()  # noqa: E731
    recs = []
    for _ in range(4):
        hr = rng.integers(0, 256, (10, 64, 96, 3), np.uint8)
        recs.append(tfrecord.encode_example({
            "input": [png(f[::4, ::4]) for f in hr],
            "target": [png(f) for f in hr]}))
    tfrecord.write_records(path, recs)
    chain = [{"name": "TFRecordDatasetOp", "path": path},
             {"name": "ParsePairExampleOp"},
             {"name": "RandomCropOp", "crop_size": 8, "num_img": 2},
             {"name": "NormalizeOp", "crop_size": 8},
             {"name": "RandomNoiseOp", "stddev": 0.01},
             {"name": "RepeatOp"}]
    shards = [iter(create_dataset(chain + [{"name": "BatchOp",
                                            "batch_size": 2}],
                                  seed=5, shard=(2, i))) for i in (0, 1)]
    before = {n for n in os.listdir("/dev/shm") if n.startswith("psm_")}
    it = iter(create_train_dataset(chain, 2, seed=5, num_workers=2))
    for i in range(6):
        got, want = next(it), next(shards[i % 2])
        for k in ("input", "target"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    it.close()
    after = {n for n in os.listdir("/dev/shm") if n.startswith("psm_")}
    assert not (after - before)


# ---------------------------------------------------------------------------
# SpatialEngine: one stream's frame split by rows


@pytest.mark.parametrize("c,shape", [(64, (1, 270, 480)), (48, (1, 37, 50)),
                                     (32, (1, 270, 480))])
def test_resblock_kernel_on_row_slab_plus_halo(gen, cuda, c, shape):
    """K1 on (1, rows + 2, W, C) slabs with their real halo rows (fewer
    at the frame's edges) and conv_2's residual the same slab plus
    halo: the interior rows equal the whole-frame launch's bit for bit
    (the per-pixel reduction does not depend on H)."""
    from joshupscale_torch.parallel.rows import Split

    x, w, s, t, _ = _operands(gen, c, torch.bfloat16, shape, cuda)
    h = shape[1]
    whole = resblock_conv3x3(resblock_conv3x3(x, w, s, t), w, s, t, x)
    for slabs in (2, 4):
        split = Split([i * h // slabs for i in range(slabs)] + [h],
                      [cuda] * slabs)
        xs = split.scatter(x)
        ys = split.with_halo(lambda i, u: resblock_conv3x3(u, w, s, t),
                             [xs], 1, 1)
        before = resblock_conv3x3.launches
        out = split.with_halo(
            lambda i, u, r: resblock_conv3x3(u, w, s, t, r), [ys, xs], 1, 1)
        assert resblock_conv3x3.launches == before + slabs
        assert torch.equal(split.gather(out, cuda), whole)


@pytest.mark.parametrize("arch", ["quality", "ps2"])
def test_spatial_engine_on_card_matches_engine(gen, cuda, arch):
    """``SpatialEngine(['cuda:0', 'cuda:0'])`` (eager, K1 on slab plus
    halo, K2 per slab) against ``Engine`` (its replayed graph) on the
    card, 4 frames and a frame after ``reset()``: within 1 u8 step (bit
    for bit unless a library conv picks another algorithm for a slab's
    height; ``chip_smoke.py`` names the layer), with the whole frame's
    K1 count per slab and one K2 per slab."""
    from joshupscale_torch.parallel import SpatialEngine

    config = (_quality_config("bfloat16") if arch == "quality"
              else _ps2_config("bfloat16"))
    built = create_models(config, seed=4)["inference"]
    m = built.obj
    frames = gen.integers(0, 256, (4, m.frame_height, m.frame_width, 3)
                          ).astype(np.uint8)
    engine = Engine(m, built.params)
    want = [engine.process(f) for f in frames]
    spatial = SpatialEngine(m, built.params, devices=["cuda:0", "cuda:0"])
    k1, k2 = resblock_conv3x3.launches, d2s_display_u8.launches
    got = [spatial.process(f) for f in frames]
    k1_frame = engine.graph_launches["resblock_conv3x3"]
    assert resblock_conv3x3.launches - k1 == 4 * 2 * k1_frame
    assert d2s_display_u8.launches - k2 == 4 * 2
    spatial.reset()
    got.append(spatial.process(frames[0]))
    for g, w_ in zip(got, want + want[:1]):
        assert g.shape == w_.shape
        assert np.abs(g.astype(np.int32) - w_.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("arch", ["quality", "ps2"])
def test_spatial_engine_across_card_and_cpu(gen, cuda, arch):
    """``SpatialEngine(['cuda:0', 'cpu'])``: slab 0 on the card, slab 1
    on the CPU (its plain versions), so every halo row, gathered table
    and whole-tensor layer crosses devices and each slab must read its
    own device's params.  Against ``Engine`` on the card in float32,
    4 frames: u8 within 1 step, the card-vs-CPU bound of
    ``test_engine_cuda_matches_cpu``."""
    from joshupscale_torch.parallel import SpatialEngine

    config = (_quality_config("float32") if arch == "quality"
              else _ps2_config("float32"))
    built = create_models(config, seed=4)["inference"]
    m = built.obj
    frames = gen.integers(0, 256, (4, m.frame_height, m.frame_width, 3)
                          ).astype(np.uint8)
    engine = Engine(m, built.params)
    spatial = SpatialEngine(m, built.params, devices=["cuda:0", "cpu"])
    assert [d.type for d in spatial.devices] == ["cuda", "cpu"]
    for f in frames:
        got, want = spatial.process(f), engine.process(f)
        assert got.shape == want.shape
        assert np.abs(got.astype(np.int32)
                      - want.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("trainer", ["frvsr", "gan"])
def test_mesh_step_on_shared_card_matches_one_process(cuda, trainer):
    """2 gloo ranks on ``cuda:0`` (``parallel.mesh``) against the
    one-process card step on the same global batch 4 and noise, 2 steps
    at 16 filters: FRVSR's all-reduced gradients within 1e-4 relative L2
    of the one-process gradients at the ranks' params
    (``replay_grads``), its loss within 1e-5 relative; the GAN's gate
    decisions equal and gen_loss within 2e-3; the ranks' params bit for
    bit."""
    from joshupscale_torch.parallel.mesh import launch
    from joshupscale_torch.tools import mesh_parity as mp

    gan = trainer == "gan"
    run = mp.make_run(mp.frvsr_models((16, 1), (16, 1), gan=gan,
                                      lr=1e-5 if gan else 5e-4),
                      trainer, 4, 10 if gan else 4, 8, 2)
    one = mp.run_steps(None, run, cuda)
    meshed = launch(mp.run_steps, 2, run, devices=["cuda:0", "cuda:0"])
    replay = None if gan else mp.replay_grads(run, meshed["update_params"],
                                              cuda)
    res = mp.compare(one, meshed, replay)
    assert res["ranks_identical"], res
    if gan:
        assert res["gates"][0] == res["gates"][1], res
        assert res["loss_rel"] <= 2e-3, res
    else:
        assert res["grad_rel"] <= 1e-4 and res["loss_rel"] <= 1e-5, res


def _profiled(fn):
    """``fn()`` under a ``torch.profiler`` session with the card's
    activities: the session's records as (name, start, end, on_card)."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
             e.device_type() != DeviceType.CPU)
            for e in prof.profiler.kineto_results.events()]


@pytest.mark.parametrize("arch", ["quality", "ps2"])
def test_marked_graph_frames_equal_plain_graph(gen, cuda, arch):
    """Frames replayed while a profiler session is active (the marked
    frame graph, captured with the plain one) equal an unprofiled
    engine's (the plain graph) bit for bit, over 6 frames with a
    ``reset()`` after the third, profiled and unprofiled frames taking
    turns on the one recurrent state."""
    from joshupscale_torch.kernels.markers import stage_end

    config = (_quality_config("bfloat16") if arch == "quality"
              else _ps2_config("bfloat16"))
    built = create_models(config, seed=6)["inference"]
    m = built.obj
    frames = gen.integers(0, 256, (6, m.frame_height, m.frame_width, 3)
                          ).astype(np.uint8)
    plain = Engine(m, built.params)
    marked = Engine(m, built.params)
    want, got = [], []
    for i, f in enumerate(frames):
        if i == 3:
            plain.reset()
            marked.reset()
        want.append(plain.process(f))
        if i % 2 == 0:
            _profiled(lambda: got.append(marked.process(f)))
        else:
            got.append(marked.process(f))
    assert stage_end.launches > 0
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)


@pytest.mark.parametrize("tier,k1", [("inference_quality", 68),
                                     ("inference_ps2_style", 48)])
def test_profiled_replays_hold_the_stage_markers(gen, cuda, tier, k1):
    """The OBS quality and PS2-style tiers (their nets, at 32 x 48):
    with the profiler off the engine replays the plain graph only (the
    graph's K1 and K2 launches as always, no marker launched, no marked
    graph); a profiled stretch holds, inside each ``engine.process``
    span, the staging, input-copy, replay and readback spans in order
    and exactly the three markers in stage order, with the tier's K1
    count and one K2 a replay; no span is mirrored onto the card's
    timeline (they are no user annotations)."""
    from pathlib import Path

    from joshupscale_torch.export.package import load_model_config
    from joshupscale_torch.kernels.markers import MARKERS, stage_end

    config = load_model_config(str(Path(__file__).resolve().parent.parent
                                   / "configs" / f"{tier}.yaml"))
    config["inference"] = dict(config["inference"], frame_height=32,
                               frame_width=48)
    built = create_models(config, seed=7)["inference"]
    engine = Engine(built.obj, built.params)
    assert engine.graph_launches == _graph_launches(k1, 1, 1)
    frames = gen.integers(0, 256, (5, 32, 48, 3)).astype(np.uint8)
    before = stage_end.launches
    for f in frames[:2]:
        engine.process(f)
    assert stage_end.launches == before

    def stretch():
        import time

        engine.process(frames[2])
        torch.cuda.synchronize()
        time.sleep(0.05)
        for f in frames[3:]:
            engine.process(f)

    records = _profiled(stretch)
    calls = sorted((r for r in records
                    if r[0] == "engine.process" and not r[3]),
                   key=lambda r: r[1])[1:]
    assert len(calls) == 2
    spans = ["engine.stage_wait", "engine.stage_copy", "engine.h2d",
             "engine.replay", "engine.readback"]
    for _, start, end, _ in calls:
        inside = sorted((r for r in records if start <= r[1] < end),
                        key=lambda r: r[1])
        host = [r[0] for r in inside
                if not r[3] and r[0].startswith("engine.")]
        assert host == ["engine.process"] + spans
        kernels = [r[0] for r in inside if r[3]]
        assert not [k for k in kernels if k.startswith("engine.")]
        assert [k for k in kernels if k in MARKERS] == list(MARKERS)
        assert sum("conv3x3" in k for k in kernels) == k1
        assert sum("d2s_display" in k for k in kernels) == 1


def test_replay_kernels_profiles_the_served_graph(gen, cuda):
    """``tools/profile_step.replay_kernels``, on which the kernel-count
    checks and the device-time profiles of a frame graph rest, profiles
    the graph that the engine serves (``spans.unmarked``): the OBS
    quality tier's 68 K1 and one K2 a replay and no marker; a profiled
    ``process`` after it replays the marked graph."""
    from pathlib import Path

    from joshupscale_torch.export.package import load_model_config
    from joshupscale_torch.kernels.markers import MARKERS
    from joshupscale_torch.tools.profile_step import replay_kernels

    config = load_model_config(str(Path(__file__).resolve().parent.parent
                                   / "configs" / "inference_quality.yaml"))
    config["inference"] = dict(config["inference"], frame_height=32,
                               frame_width=48)
    built = create_models(config, seed=8)["inference"]
    engine = Engine(built.obj, built.params)
    frames = gen.integers(0, 256, (2, 32, 48, 3)).astype(np.uint8)
    _, events, per = replay_kernels(
        engine, torch.from_numpy(frames[0][None]).to(cuda))
    assert per == (68, 1)
    assert not [e for e in events if e["name"] in MARKERS]

    def stretch():
        import time

        engine.process(frames[1])
        torch.cuda.synchronize()
        time.sleep(0.05)
        engine.process(frames[0])

    records = sorted(_profiled(stretch), key=lambda r: r[1])
    assert [r[0] for r in records if r[3] and r[0] in MARKERS][-3:] == list(
        MARKERS)
