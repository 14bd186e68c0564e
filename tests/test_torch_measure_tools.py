"""The port's measurement tools (``joshupscale_torch/tools/``:
``run_native``, ``profile_step``, ``serving_check``, ``latency_probe``,
``pipeline_probe``, ``train_step_bench``, ``profile_train_step``,
``fit_overlap_bench``, ``fit_cost_probe``) on the CPU: their tables and builders against the JAX tools' (``tools/``),
what they compute against the JAX package at small sizes (weights
carried across with ``flatten_params`` -> ``from_flat_numpy``), their
trace and clock arithmetic on handmade inputs, and their refusal to
run without a card unless ``--cpu`` is given.  What they measure needs
the card."""

import contextlib
import io
import json
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import joshupscale_tpu.models as j_models
from joshupscale_tpu.export.importer import flatten_params
from joshupscale_tpu.models import create_models as j_create_models
from joshupscale_tpu.runtime.engine import Engine as JEngine
from joshupscale_torch.export.weights import from_flat_numpy
from joshupscale_torch.models.registry import create_models
from joshupscale_torch.tools import (
    fit_cost_probe,
    latency_probe,
    pipeline_probe,
    profile_step,
    profile_train_step,
    run_native,
    train_step_bench,
)

TOOLS = ("run_native", "profile_step", "serving_check", "latency_probe",
         "pipeline_probe", "train_step_bench", "profile_train_step",
         "fit_overlap_bench", "fit_cost_probe")
H, W = 16, 24


def _small(compute_dtype="float32"):
    """The quality architecture cut to 32 filters and 1 res block."""
    return {
        "flow": {"name": "flow-resnet", "num_inputs": 4, "num_filters": 32,
                 "num_res_blocks": 1},
        "generator": {"name": "generator-resnet", "num_filters": 32,
                      "num_res_blocks": 1},
        "inference": {"name": "inference", "generator": {"model": "generator"},
                      "flow": {"model": "flow"}, "skip_processing": False,
                      "frame_height": H, "frame_width": W,
                      "compute_dtype": compute_dtype},
    }


# ---------------------------------------------------------------- tables

def test_latency_tables_match_the_jax_tool_and_cover_the_model_set():
    """``QUALITY_CONFIG`` / ``TIER_CONFIGS`` are the JAX tool's, and every
    tier ``make_model_set`` writes is one of them."""
    import tools.latency_probe as j_tool
    from joshupscale_torch.export.package import load_model_config
    from joshupscale_torch.tools.make_model_set import MODEL_CONFIGS

    assert latency_probe.QUALITY_CONFIG == j_tool.QUALITY_CONFIG
    assert latency_probe.TIER_CONFIGS == j_tool.TIER_CONFIGS
    for path in MODEL_CONFIGS.values():
        assert (path in latency_probe.TIER_CONFIGS.values()
                or load_model_config(os.path.join(latency_probe.REPO, path))
                == latency_probe.QUALITY_CONFIG), path
    for tier in ("quality",) + tuple(latency_probe.TIER_CONFIGS):
        assert latency_probe.load_tier(tier) == j_tool.load_tier(tier)


@pytest.mark.parametrize("values", [
    [5.3, 5.2, 5.4, 5.25, 9.0],
    list(np.linspace(1.0, 2.0, 200)),
    [7.0],
])
def test_latency_stats_equal_numpy(values):
    got = latency_probe.latency_stats(values)
    v = np.asarray(values)
    assert got == {"mean_ms": pytest.approx(v.mean()),
                   "p50_ms": np.percentile(v, 50),
                   "p90_ms": np.percentile(v, 90),
                   "p99_ms": np.percentile(v, 99), "max_ms": v.max()}


@pytest.mark.parametrize("tier,want", [
    ("quality", (68, 1)), ("fast", (36, 1)), ("ps2", (48, 1)),
    ("ps2_fast", (24, 1))])
def test_expected_launches_by_tier(tier, want):
    """K1 / K2 a frame of each tier, which ``profile_step`` and
    ``latency_probe`` hold the card's counts to (the counts
    ``chip_smoke.py`` checks each tier's artifact against)."""
    config = latency_probe.load_tier(tier)
    config["inference"].update(frame_height=H, frame_width=W)
    model = create_models(config)["inference"].obj
    assert profile_step.expected_launches(config, model) == want


@pytest.mark.parametrize("trainer", ["frvsr", "gan"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("warp", [False, True])
def test_train_step_bench_config_is_the_jax_tools(monkeypatch, trainer,
                                                  dtype, warp):
    """``train_config`` is the config the JAX tool's ``_build`` builds
    (its ``create_models`` replaced by a recorder: nothing compiles)."""
    import tools.train_step_bench as j_tool

    seen = {}

    def record(config, seed=0):
        seen["config"] = config
        return {trainer: types.SimpleNamespace(params={"vgg": {}})}

    monkeypatch.setattr(j_models, "create_models", record)
    j_tool._build(trainer, dtype, 32, 4, warp)
    assert train_step_bench.train_config(trainer, dtype, warp) == \
        seen["config"]


# ------------------------------------------------- against the JAX package

def test_profile_step_build_matches_the_jax_build_step(rng, tmp_path):
    """``build_step`` at 16x24 (cut depth, bf16, a tier YAML) serves the
    JAX ``build_step``'s model and params (carried across) to the same
    u8 frames within the slice's bf16 bound."""
    import tools.profile_step as j_tool

    path = tmp_path / "small.yaml"
    path.write_text(yaml.safe_dump({"models": _small("bfloat16")}))
    _, j_params, _, j_model = j_tool.build_step(H, W, config_path=str(path))
    engine, config = profile_step.build_step(
        H, W, config_path=str(path), device="cpu",
        params=from_flat_numpy(flatten_params(j_params)))
    assert config == _small("bfloat16")
    ref_engine = JEngine(j_model, j_params)
    frames = rng.integers(0, 256, (3, H, W, 3)).astype(np.uint8)
    for f in frames:
        diff = np.abs(engine.process(f).astype(int)
                      - np.asarray(ref_engine.process(f)).astype(int))
        assert diff.max() <= 2
        assert (diff > 0).mean() <= 0.10


def test_pipeline_stages_match_jax(rng):
    """``pipeline_probe.stages`` (stage F then G on a CPU
    ``PipelinedEngine``) and its payload's bytes against the JAX
    model's ``apply_flow_stage`` / ``apply_gen_stage`` (f32)."""
    from joshupscale_tpu.export.importer import unflatten_into
    from joshupscale_torch.parallel import PipelinedEngine

    config = _small()
    built = j_create_models(config, seed=0)["inference"]
    flat = flatten_params(built.params)
    j_params = unflatten_into(built.params, flat)
    model = create_models(config)["inference"].obj
    engine = PipelinedEngine(model, from_flat_numpy(flat),
                             devices=("cpu", "cpu"))
    frame = rng.integers(0, 256, (1, H, W, 3)).astype(np.uint8)
    inter, outputs = pipeline_probe.stages(engine, torch.from_numpy(frame))
    state = built.obj.init_state(1)
    j_inter, _ = built.obj.apply_flow_stage(
        {"flow": j_params["flow"]}, jnp.asarray(frame),
        {"last_frames": state["last_frames"]})
    j_out, _ = built.obj.apply_gen_stage(
        {"generator": j_params["generator"]}, j_inter,
        {"pre_gen": state["pre_gen"]})
    assert sorted(inter) == sorted(j_inter)
    for k, v in inter.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(j_inter[k]),
                                   atol=1e-4, rtol=0)
    np.testing.assert_allclose(outputs["output_s2d"].numpy(),
                               np.asarray(j_out["output_s2d"]), atol=1e-4,
                               rtol=0)
    assert pipeline_probe.payload_bytes(inter) == sum(
        np.asarray(v).nbytes for v in j_inter.values())


def test_fit_cost_u8_staging_equals_float_staging():
    """Variant G's staging (u8 across, normalized on the device) gives the
    float staging of the same u8 values (normalized on the host in
    float32) bit for bit."""
    from joshupscale_torch.tools.gan_soak import synth_video_batch

    b8 = fit_cost_probe.to_u8(synth_video_batch(
        np.random.default_rng(0), 2, 8))
    got = fit_cost_probe.stage_u8(b8, torch.device("cpu"))
    want = fit_cost_probe.stage_float(
        {k: v.astype(np.float32) / 255 - 0.5 for k, v in b8.items()},
        torch.device("cpu"))
    for k in b8:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k])


# ------------------------------------------------------ trace arithmetic

def _events(*rows):
    return [{"name": n, "ts": ts, "dur": dur} for n, ts, dur in rows]


def test_frame_profile_groups_divides_and_counts_overlap_once():
    """Two frames' records: parts by ``kernel_group`` a frame, a PDL
    overlap (K1 into K1) counted once, the window and idle share."""
    events = _events(
        ("resblock_conv3x3_kernel", 0, 10), ("resblock_conv3x3_kernel", 6, 10),
        ("d2s_display_u8_kernel", 20, 4), ("cudnn_conv_fprop", 30, 6),
        ("resblock_conv3x3_kernel", 100, 10),
        ("resblock_conv3x3_kernel", 106, 10),
        ("d2s_display_u8_kernel", 120, 4), ("cudnn_conv_fprop", 130, 6))
    prof = profile_step.frame_profile(events, 2, top=2)
    assert prof["parts"] == pytest.approx(
        {profile_step.K1: 0.016, profile_step.K2: 0.004,
         "library convs": 0.006})
    assert prof["busy_ms"] == pytest.approx(0.026)
    assert prof["window_ms"] == pytest.approx(0.068)
    assert prof["idle_share"] == pytest.approx(1 - 26 / 68)
    assert prof["ops"] == 4
    assert prof["top"][0] == ("resblock_conv3x3_kernel", pytest.approx(0.02))


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::warp_s2d_bilinear<1, 1>(void const*, "
     "void const*, void*, int, int, int, int, long long, long long, "
     "long long, float)", "warp s2d (fused)"),
    ("void at::native::index_elementwise_kernel<128, 4>",
     "warp row gather (index)"),
    ("resblock_conv3x3_kernel<64, true>", "K1 resblock_conv3x3")])
def test_kernel_group_gives_the_fused_warp_its_own_group(name, group):
    """K3's kernel, as the profiler names it, counts in a group of its
    own (``profile_step.K3``), apart from the plain path's row gather."""
    assert profile_step.kernel_group(name) == group


def test_after_gap_keeps_the_records_after_the_idle_gap():
    gap_us = profile_step.REPLAY_GAP_S * 1e6
    warm = _events(("a", 0, 5), ("b", 6, 5))
    counted = _events(("c", 11 + gap_us, 5), ("d", 17 + gap_us, 5))
    assert profile_step.after_gap(warm + counted) == counted
    assert profile_step.after_gap(warm) == warm


def test_counted_session_reruns_a_short_count_and_stops_on_a_long_one():
    seen = []
    counts = iter([(60, 1), (68, 1)])
    assert profile_step.counted_session("x", lambda: next(counts), (68, 1),
                                        seen.append) == ((68, 1), 2)
    assert len(seen) == 1
    counts = iter([(70, 1), (68, 1)])
    assert profile_step.counted_session("x", lambda: next(counts), (68, 1),
                                        seen.append) == ((70, 1), 1)


def test_device_split_and_host_copies():
    events = _events(("Memcpy HtoD (Pageable -> Device)", 0, 100),
                     ("cudnn_conv_wgrad", 100, 300),
                     ("multi_tensor_apply_kernel", 400, 100))
    split = profile_train_step.device_split("t", "bf16", events, 2, 1.0,
                                            lambda m: None)
    assert split["busy_ms"] == pytest.approx(0.25)
    assert split["idle_share"] == pytest.approx(0.75)
    assert split["groups"]["foreach (Adam, BN merge)"] == pytest.approx(0.05)
    assert [profile_train_step.host_copy(e) for e in events] == [
        True, False, False]


# ------------------------------------------------------ upscale_cli clocks

def test_outside_clock_and_quotient_arithmetic():
    """The outside clock is the mean stamp interval past the warm-up
    frames; the CLI's difference quotient divides by the frames between
    the runs, whatever the runs wrote to."""
    stamps = np.concatenate([np.arange(20) * 0.050,
                             0.95 + np.arange(1, 301) * 0.003])
    assert run_native.steady_ms(stamps) == pytest.approx(3.0)
    assert run_native.steady_ms(stamps[:8]) == pytest.approx(50.0)
    long_run = {"cli_s": 1.20, "stamps": np.zeros(320)}
    short_run = {"cli_s": 0.30, "stamps": np.zeros(20)}
    assert run_native.quotient_ms(long_run, short_run) == pytest.approx(3.0)


_FAKE_CLI = r'''
import sys, time
args = sys.argv[1:]
pipeline = args[0] == "--pipeline"
package, src, dst, n = args[pipeline:]
frame, out = 32 * 48 * 3, b"\0" * (16 * 32 * 48 * 3)
clocked = 0.0
with open(src, "rb", buffering=0) as f, open(dst, "wb") as g:
    for _ in range(int(n)):
        got = 0
        while got < frame:  # no read-ahead, as upscale_cli's fread
            got += len(f.read(frame - got))
        t = time.perf_counter()
        time.sleep(0.002)          # the clocked call
        clocked += time.perf_counter() - t
        time.sleep(0.010)          # the host's file work, unclocked
        g.write(out)
print(f"processed {n} frames, avg {clocked / int(n) * 1e3:.3f} ms/frame",
      file=sys.stderr)
'''


def test_cli_run_stamps_frames_from_outside(tmp_path):
    """``cli_run`` feeds a CLI through a FIFO and stamps each frame as it
    is taken: the stamps' interval holds the work the CLI leaves off its
    own clock (here a stand-in CLI that clocks 2 ms of each 12 ms
    frame)."""
    cli = tmp_path / "fake_cli.py"
    cli.write_text(_FAKE_CLI)
    cli.chmod(0o755)
    wrapper = tmp_path / "cli"
    wrapper.write_text(f"#!/bin/sh\nexec {sys.executable} {cli} \"$@\"\n")
    wrapper.chmod(0o755)
    frames = np.zeros((12, 32, 48, 3), np.uint8)
    run = run_native.cli_run(None, "pkg", frames, True, True, keep=True,
                             cli=str(wrapper))
    assert run["out"].shape == (12, 128, 192, 3)
    assert len(run["stamps"]) == 12
    cli_ms = run["cli_s"] / 12 * 1e3
    assert 2.0 <= cli_ms < 10.0
    # The pipe holds 3.5 frames: the stamps keep the CLI's pace from the
    # fifth frame on.
    assert run_native.pipe_bytes(frames[0].nbytes) == 16384
    read, write = os.pipe()
    try:
        assert run_native.set_pipe_size(
            write, run_native.pipe_bytes(270 * 480 * 3)) >= 1 << 16
    finally:
        os.close(read)
        os.close(write)
    assert run_native.steady_ms(run["stamps"], start=5) >= 11.5


# ------------------------------------------------- card only, unless --cpu

@pytest.mark.parametrize("tool", TOOLS)
def test_tool_refuses_to_run_without_a_card(monkeypatch, tool):
    """Without a card and without ``--cpu`` every tool exits non-zero and
    says why; none falls back to the CPU."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(f"joshupscale_torch.tools.{tool}").main
    with pytest.raises(SystemExit) as exc:
        main([])
    assert "no CUDA device" in str(exc.value.code)


@pytest.mark.parametrize("tool,argv", [
    ("latency_probe", ["--frames", "4", "--warmup", "1"]),
    ("train_step_bench", ["--trainers", "frvsr", "--dtypes", "float32",
                          "--k", "1", "--reps", "1"]),
])
def test_cpu_tiny_rehearsal_runs_end_to_end(tool, argv):
    """``--cpu --tiny`` runs a serving tool and a training tool through;
    their result lines say ``cpu``."""
    import importlib

    main = importlib.import_module(f"joshupscale_torch.tools.{tool}").main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["--cpu", "--tiny"] + argv) == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["on"] == "cpu"
    if tool == "latency_probe":
        assert result["device"] is None and result["frames"] == 4
    else:
        assert "event_ms_per_step" not in result
