"""Port parity for the int8 serving tier vs the JAX package.

``quantize_kernel_int8``, ``quantize_params_int8``, ``kl_threshold`` and
the histogram binning against the reference bit for bit; the int8 conv
against the reference's compiled one; whole int8 models through both
engines (resnet and autoencoder flow nets, s2d and pixel tails,
``remove_flow``, calibrated ranges) at small sizes; ``calibrate`` with
its three methods; int8 params in a package, refused on both sides.
Params are carried across with ``flatten_params`` -> ``from_flat_numpy``;
inputs come from numpy.  Every tolerance is stated with its reason.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import flat_params, u8_diff, u8_frames
from joshupscale_tpu.export import quantize as jq
from joshupscale_tpu.export.importer import flatten_params, unflatten_into
from joshupscale_tpu.export.package import load_package as j_load_package
from joshupscale_tpu.export.package import save_package as j_save_package
from joshupscale_tpu.nn import layers as jlayers
from joshupscale_tpu.runtime.engine import Engine as JEngine
from joshupscale_torch.export import quantize as tq
from joshupscale_torch.export.package import load_package, save_package
from joshupscale_torch.export.weights import from_flat_numpy, to_flat_numpy
from joshupscale_torch.models.registry import create_models
from joshupscale_torch.nn import layers as tlayers
from joshupscale_torch.runtime.engine import Engine

H, W = 16, 24


def _config(compute_dtype="float32", flow=None, **inference):
    return {
        "flow": flow or {"name": "flow-resnet", "num_inputs": 4,
                         "num_filters": 32, "num_res_blocks": 1},
        "generator": {"name": "generator-resnet", "num_filters": 32,
                      "num_res_blocks": 1},
        "inference": {"name": "inference", "flow": {"model": "flow"},
                      "generator": {"model": "generator"},
                      "skip_processing": False, "frame_height": H,
                      "frame_width": W, "compute_dtype": compute_dtype,
                      **inference},
    }


_AE = {"name": "flow-autoencoder", "num_inputs": 4,
       "filters": [8, 16, 32, 16, 8]}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_leaves(v, path))
        else:
            out[path] = v
    return out


@pytest.mark.parametrize("shape,deconv", [((3, 3, 16, 32), False),
                                          ((1, 1, 64, 32), False),
                                          ((2, 2, 32, 64), True)])
def test_quantize_kernel_int8_bit_exact(rng, shape, deconv):
    """q and the scale equal the reference's on the same kernel in the
    port's layout (OHWI, or the deconv's (I, 4*O) product), a zero
    channel included (scale 1.0)."""
    k = rng.standard_normal(shape).astype(np.float32)
    k[..., 0] = 0.0
    q_ref, s_ref = jq.quantize_kernel_int8(k)
    tree = from_flat_numpy({("conv_trans_1" if deconv else "conv_1")
                            + ".kernel": k})
    kernel = next(iter(tree.values()))["kernel"]
    q, s = tq.quantize_kernel_int8(kernel.numpy())
    back = to_flat_numpy({"conv_trans_1" if deconv else "conv_1":
                          {"kernel_q": torch.from_numpy(q)}})
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(next(iter(back.values())), q_ref)
    np.testing.assert_array_equal(s, s_ref)


@pytest.mark.parametrize("min_elements,with_ranges",
                         [(4096, False), (0, False), (4096, True),
                          (0, True)])
def test_quantize_params_int8_bit_exact(min_elements, with_ranges):
    """The port's quantize of the carried float params equals the
    reference's quantize carried across, leaf for leaf and bit for bit:
    which layers stay float (``min_elements`` on the kernel's element
    count; the deconvs included), ``kernel_q``, ``kernel_scale`` and
    ``act_scale = range / 127``."""
    built, flat = flat_params(_config(s2d_mode=False))
    ranges = None
    if with_ranges:
        ranges = {"flow.conv_1": 1.7, "generator.block_1.conv_2": 3.25,
                  "generator.conv_trans_1": 0.9, "flow.conv_2": 2.0}
    j_q = jq.quantize_params_int8(unflatten_into(built.params, flat),
                                  min_elements=min_elements, ranges=ranges)
    want = _leaves(from_flat_numpy(flatten_params(j_q)))
    got = _leaves(tq.quantize_params_int8(from_flat_numpy(flat),
                                          min_elements=min_elements,
                                          ranges=ranges))
    assert sorted(got) == sorted(want)
    assert any(k.endswith("kernel_q") for k in got)
    assert (any(k.endswith("act_scale") for k in got)) == with_ranges
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_kl_threshold_matches_reference():
    """The port's copy of the numpy search picks the same bin."""
    rng = np.random.default_rng(0)
    x = np.concatenate([np.abs(rng.standard_normal(200_000)),
                        np.full(5, 20.0)])
    cases = [np.histogram(x, bins=2048, range=(0.0, 20.0))[0],
             np.histogram(rng.uniform(0, 1, 50_000), bins=512,
                          range=(0.0, 1.0))[0],
             np.zeros(2048), np.ones(64)]
    for hist in cases:
        assert tq.kl_threshold(hist) == jq.kl_threshold(hist)


@pytest.mark.parametrize("bins", [2048, 512, 1000, 37])
def test_histogram_bins_as_jnp_histogram(rng, bins):
    """Edges and counts equal ``jnp.histogram(|x|, bins, range=(0,
    top))``: the edges as XLA computes its linspace, values on an edge
    in the bin above it, ``top`` in the last bin."""
    x = rng.standard_normal(20_000).astype(np.float32) * 3
    top = float(np.abs(x).max())
    edges = tq.histogram_edges(top, bins)
    x[:bins] = edges[:bins] * np.sign(x[:bins])  # values on the edges
    ref, ref_edges = jnp.histogram(jnp.abs(jnp.asarray(x)), bins=bins,
                                   range=(0.0, top))
    np.testing.assert_array_equal(edges, np.asarray(ref_edges))
    got = tq.abs_histogram(torch.from_numpy(x), torch.from_numpy(edges))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _conv_case(rng, cin, k, bias, static, big):
    if big:  # one-signed operands: the int32 sums pass 2^24
        x = rng.uniform(0.5, 1.0, (1, 6, 7, cin)).astype(np.float32)
        w = rng.uniform(0.5, 1.0, (k, k, cin, 16)).astype(np.float32)
    else:
        x = rng.standard_normal((2, 6, 7, cin)).astype(np.float32)
        w = (rng.standard_normal((k, k, cin, 16)) * 0.1).astype(np.float32)
    p = {"kernel": w}
    if bias:
        p["bias"] = rng.standard_normal(16).astype(np.float32)
    qp = jq.quantize_params_int8({"c": {k_: jnp.asarray(v)
                                        for k_, v in p.items()}},
                                 min_elements=0,
                                 ranges={"c": 2.5} if static else None)
    tp = from_flat_numpy({f"c.{k_}": np.asarray(v)
                          for k_, v in qp["c"].items()})["c"]
    return x, qp["c"], tlayers.prepare_conv_int8(tp)


_CONV_CASES = [(51, 3, False, False, False), (51, 3, True, True, False),
               (12, 3, False, True, False), (64, 1, True, False, False),
               (256, 3, False, False, True)]


@pytest.mark.parametrize("cin,k,bias,static,big", _CONV_CASES)
def test_int8_conv_matches_reference(rng, cin, k, bias, static, big):
    """The int8 conv against the reference's compiled one (its serving
    numerics: ``absmax / 127`` folded to a product with the reciprocal,
    the bias added by one multiply-add): bit for bit in float32 and in
    bf16 -- the quotient, its ties, the int32 sums (past 2^24 in the
    C_in = 256 case, where a float32 accumulation would round) and the
    dequantization all agree."""
    x, jp, tp = _conv_case(rng, cin, k, bias, static, big)
    if big:
        scale = np.float32(np.abs(x).max()) * (np.float32(1) / 127)
        xq = np.clip(np.round(x / scale), -127, 127).astype(np.int64)
        kq = np.asarray(jp["kernel_q"]).astype(np.int64)
        centre = sum(xq[0, 2 + dy, 3 + dx] @ kq[dy + 1, dx + 1]
                     for dy in (-1, 0, 1) for dx in (-1, 0, 1))
        assert centre.max() > 2 ** 24
    conv = jax.jit(jlayers.conv2d)
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        ref = np.asarray(conv(jp, jnp.asarray(x).astype(jdt)).astype(
            jnp.float32))
        got = tlayers.conv2d(tp, torch.from_numpy(x).to(dtype))
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), ref)


def _engines(config, min_elements=4096, ranges=None, seed=0):
    """(reference engine, port engine on the CPU) serving the reference's
    int8 params, carried across."""
    built, flat = flat_params(config, seed)
    j_q = jq.quantize_params_int8(unflatten_into(built.params, flat),
                                  min_elements=min_elements, ranges=ranges)
    t_model = create_models(config, seed=seed)["inference"].obj
    t_q = from_flat_numpy(flatten_params(j_q))
    return JEngine(built.obj, j_q), Engine(t_model, t_q, device="cpu")


_MODEL_CASES = {
    "resnet_s2d": ({}, 0),
    "resnet_s2d_default": ({}, 4096),
    "resnet_pixel": ({"s2d_mode": False}, 0),
    "autoencoder": ({"flow": _AE, "flow_pad_factor": 8,
                     "normalize_brightness": True}, 0),
    "remove_flow": ({"remove_flow": True}, 0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_MODEL_CASES))
def test_int8_model_matches_reference(rng, case, dtype):
    """Whole int8 models through both engines, 3 frames.  f32: u8 within
    1 step (the float convs, warps and tails sum in other orders, and a
    float difference reaching a conv input can move one quantization
    level; the largest seen is 1).  bf16: within 2 steps, mean under
    0.1 (both sides round bf16 at other places -- the reference's fused
    elementwise work keeps float32 between ops -- which moves a level
    now and then; the largest seen is 1, mean 0.03-0.07)."""
    options, min_elements = _MODEL_CASES[case]
    options = dict(options)
    flow = options.pop("flow", None)
    config = _config(dtype, flow=flow, **options)
    if options.get("remove_flow"):
        del config["flow"], config["inference"]["flow"]
    ref, got = _engines(config, min_elements)
    for f in u8_frames(rng, 3, H, W):
        d = u8_diff(got.process(f), ref.process(f))
        if dtype == "float32":
            assert d.max() <= 1, case
        else:
            assert d.max() <= 2 and d.mean() < 0.1, (case, d.max(),
                                                     d.mean())


def test_int8_ranges_model_matches_reference(rng):
    """A model with static ``act_scale`` from the reference's
    ``calibrate``: u8 within 1 step in f32 (as above)."""
    config = _config(s2d_mode=False)
    built, flat = flat_params(config)
    frames = u8_frames(rng, 3, H, W)[:, None]
    ranges = jq.calibrate(built.obj, unflatten_into(built.params, flat),
                          jnp.asarray(frames))
    ref, got = _engines(config, 0, ranges)
    assert any("act_scale" in k for k in _leaves(got.params["generator"]))
    for f in u8_frames(rng, 3, H, W):
        assert u8_diff(got.process(f), ref.process(f)).max() <= 1


_CAL_CASES = {"pixel": {"s2d_mode": False}, "s2d": {},
              "remove_flow": {"remove_flow": True, "s2d_mode": False}}


@pytest.mark.parametrize("case", sorted(_CAL_CASES))
def test_calibrate_matches_reference(rng, case):
    """``calibrate`` with all three methods on the CPU: the reference's
    keys letter for letter (the deconvs only in the pixel tail, no
    ``generator.conv_1`` under ``remove_flow``: the reference's sweep
    does not see convs it does not know by identity); minmax and
    percentile within 1e-5 relative (the convs' inputs are float32 sums
    in another order); entropy within 2 bins of the reference's clip
    (one count moving across an edge can move the KL minimum)."""
    config = _config(**_CAL_CASES[case])
    if case == "remove_flow":
        del config["flow"], config["inference"]["flow"]
    built, flat = flat_params(config)
    j_params = unflatten_into(built.params, flat)
    t_model = create_models(config)["inference"].obj
    t_params = from_flat_numpy(flat)
    frames = u8_frames(rng, 3, H, W)[:, None]
    for method, kw in (("minmax", {}), ("percentile", {"percentile": 90.0}),
                       ("entropy", {"bins": 512})):
        want = jq.calibrate(built.obj, j_params, jnp.asarray(frames),
                            method=method, **kw)
        got = tq.calibrate(t_model, t_params, frames, method=method,
                           device="cpu", **kw)
        assert sorted(got) == sorted(want), method
        top = jq.calibrate(built.obj, j_params, jnp.asarray(frames)) if (
            method == "entropy") else None
        for k, v in want.items():
            tol = 2 * top[k] / 512 if top else 1e-5 * v
            assert abs(got[k] - v) <= tol + 1e-7, (method, k, got[k], v)
    if case == "pixel":
        assert "generator.conv_trans_1" in got
    if case == "remove_flow":
        assert "generator.conv_1" not in got


def test_calibrate_needs_a_card_by_default():
    """Entry points run on the card unless the caller names the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    built = create_models(_config())["inference"]
    with pytest.raises(RuntimeError):
        tq.calibrate(built.obj, built.params,
                     np.zeros((1, 1, H, W, 3), np.uint8))


def test_int8_package_refused_on_both_sides(tmp_path):
    """A package whose ``params.npz`` holds int8 params loads on neither
    side: the reference's ``load_package`` unflattens into the float
    template and misses ``kernel`` (KeyError), and so does the port's
    (``registry.load_into``).  The int8 tier is made at load time, from
    float params, with ``quantize_params_int8``."""
    config = _config()
    built, flat = flat_params(config)
    j_built = built
    j_built.params = jq.quantize_params_int8(
        unflatten_into(built.params, flat))
    j_save_package(str(tmp_path / "jax"), config, j_built)
    t_built = create_models(config)["inference"]
    t_built.params = tq.quantize_params_int8(from_flat_numpy(flat))
    save_package(str(tmp_path / "port"), config, t_built)
    for path in (tmp_path / "jax", tmp_path / "port"):
        with pytest.raises(KeyError):
            j_load_package(str(path))
        with pytest.raises(KeyError):
            load_package(str(path))
