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
from joshupscale_torch.models.registry import create_models
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
# quality and PS2-style tiers, 48 (96-byte rows) on PS2-fast.
_K1_CASES = ([(c, dt, (2, 19, 37)) for c in (32, 48, 64)
              for dt in (torch.bfloat16, torch.float32)]
             + [(c, torch.bfloat16, (1, 5, 7)) for c in (32, 48, 64)]
             + [(c, torch.bfloat16, (1, 270, 480)) for c in (64, 48)])


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


def _graph_launches(k1, k2):
    return {"resblock_conv3x3": k1, "d2s_display_u8": k2, "probe_dot": 0,
            "probe_patch_dot": 0}


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
    assert on_card.graph_launches == _graph_launches(2 * 4, 1)
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
    assert on_card.graph_launches == _graph_launches(
        0 if option == "output_flow" else 2 * 2, int(deferred))
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
    assert engine.graph_launches == _graph_launches(0, 1)
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
    assert batched.graph_launches == _graph_launches(2 * 4, 1)
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
