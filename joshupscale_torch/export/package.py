"""Model packages: the deployable artifact.

A package is a directory holding ``model.yaml`` (the model config and
the name of the inference entry) and ``params.npz`` (flat dotted-path
params in the reference's layouts).  Port of ``save_package`` and
``load_package`` from ``joshupscale_tpu/export/package.py``: a package
either side writes loads on the other.

``export_aoti=True`` also writes the Python-free serving set, which the
C++ host's AOTInductor backend runs (``joshupscale_torch/native/``):

    step.pt2        -- AOTInductor package of one frame, weights embedded:
                       step(frame, *state) -> (display, *new_state)
    step_spec.txt   -- its flat I/O signature and the state alias map
    state_init.bin  -- the initial state's bytes, leaf after leaf

``step_spec.txt`` and ``state_init.bin`` are letter for letter and byte
for byte what the reference's ``export_stablehlo=True`` writes for the
same model (its ``_write_native_serving_artifacts``), so one parser
(``native/src/step_spec.cc``) reads both.  The state flattens in the
reference's leaf order: a dict's keys sorted (``last_frames`` before
``pre_gen``), a list in order.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from joshupscale_torch import DeviceLike, resolve_device
from joshupscale_torch.export.weights import load_params_npz, to_flat_numpy
from joshupscale_torch.models.inference import InferenceModel
from joshupscale_torch.models.registry import (
    BuiltModel,
    create_models,
    load_into,
)

STEP_FILE = "step.pt2"
_SPEC_DTYPES = {torch.uint8: "u8", torch.float32: "f32",
                torch.bfloat16: "bf16", torch.float16: "f16",
                torch.int32: "i32", torch.float64: "f64"}


def save_package(path: str, model_config: Dict[str, Any], built: BuiltModel,
                 inference_name: str = "inference",
                 export_stablehlo: bool = False, batch_size: int = 1,
                 export_aoti: bool = False,
                 device: DeviceLike = None):
    """Write a package for a built inference model: ``model.yaml``
    (``model_config`` and ``inference_name``) and ``params.npz``.

    ``export_aoti`` also writes the Python-free serving set (module
    docstring): the step at ``batch_size``, compiled for ``device``
    (``resolve_device``: by default the card; the CPU only if named),
    and returns its ``ExportedProgram`` (else None).  Any params serve,
    the int8 tier's (``quantize_params_int8``) among them; such a
    package is served by its set only, since ``load_package`` takes
    float params.
    ``export_stablehlo`` asks for the reference's XLA program (StableHLO)
    for its PJRT runtime; it has no counterpart on CUDA and raises
    ``NotImplementedError``: its counterpart here is ``export_aoti``.
    """
    if export_stablehlo:
        raise NotImplementedError(
            "export_stablehlo writes an XLA program (StableHLO and its "
            "compile options) for the reference's PJRT runtime; it has no "
            "counterpart on CUDA.  Its counterpart is export_aoti=True "
            "(an AOTInductor package for the C++ host).")
    import yaml  # only the package files need it

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "model.yaml"), "w") as f:
        yaml.safe_dump({"models": model_config, "inference": inference_name},
                       f)
    np.savez(os.path.join(path, "params.npz"), **to_flat_numpy(built.params))
    if export_aoti:
        return write_aoti_step(path, built.obj, built.params, batch_size,
                               device)
    return None


def state_leaves(state: Dict[str, Any]) -> List[torch.Tensor]:
    """A recurrent state's tensors in the reference's leaf order (what
    ``jax.tree_util.tree_leaves`` gives for the same dict): keys
    sorted, a list's items in order."""
    leaves = []
    for key in sorted(state):
        value = state[key]
        leaves += list(value) if isinstance(value, (list, tuple)) else [value]
    return leaves


def state_from_leaves(template: Dict[str, Any],
                      leaves) -> Dict[str, Any]:
    """The inverse of ``state_leaves``, shaped like ``template``."""
    out, it = {}, iter(leaves)
    for key in sorted(template):
        value = template[key]
        out[key] = ([next(it) for _ in value]
                    if isinstance(value, (list, tuple)) else next(it))
    return out


class ServingStep(torch.nn.Module):
    """One frame of serving as a pure function of the frame and the state
    leaves: ``(frame, *state) -> (display, *new_state)``, the display the
    u8 (N, 4H, 4W, 3) frame (the float HR frame with
    ``skip_processing``).  ``runtime/engine.py``'s ``run_step`` and
    display, with the state returned instead of committed in place."""

    def __init__(self, model: InferenceModel, params: Dict[str, Any],
                 template: Dict[str, Any]) -> None:
        super().__init__()
        self.model, self.params, self.template = model, params, template

    def forward(self, frame: torch.Tensor, *leaves: torch.Tensor):
        from joshupscale_torch.runtime.engine import _deferred, select_output
        from joshupscale_torch.kernels.display import d2s_display_u8

        outputs, new_state = self.model.apply(
            self.params, frame, state_from_leaves(self.template, leaves))
        out = select_output(self.model, outputs)
        if _deferred(self.model):
            out = d2s_display_u8(out)
        return (out, *state_leaves(new_state))


def clear_trace_caches() -> None:
    """Empty the process-wide dispatch cache of torch's fake tensors, so
    that an export traces and compiles from the state a fresh process
    has.  Its entries outlive the export that made them: on an H100 with
    torch 2.11, an artifact exported after another export of the same
    architecture whose library convs took channels-last views came out
    off ``Engine`` from frame 0 (state mean 2.0 u8 steps, then 7.5),
    where the same export in a fresh process, or after this call,
    matches (``tools/export_isolation.py``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    FakeTensorMode.cache_clear()


def export_step(model: InferenceModel, params: Dict[str, Any],
                batch_size: int = 1, device: DeviceLike = None):
    """``torch.export`` of the serving step (``ServingStep``) on serving
    params made from raw ``params`` on ``device`` (``resolve_device``:
    by default the card, which must be present; the CPU only if named),
    traced from a cleared dispatch cache (``clear_trace_caches``):
    returns ``(ExportedProgram, example inputs)``."""
    device = resolve_device(device)
    clear_trace_caches()
    serving = model.prepare_params(params, device)
    state = model.init_state(batch_size, device=device)
    dtype = torch.float32 if model.skip_processing else torch.uint8
    frame = torch.zeros((batch_size, model.frame_height, model.frame_width,
                         3), dtype=dtype, device=device)
    args = (frame, *state_leaves(state))
    step = ServingStep(model, serving, state)
    # no_grad, not inference_mode: export traces through autograd's
    # view of the ops.  One eager step first fills the ops' per-device
    # constant caches with real tensors; made during the trace, they
    # would hold its fake tensors for every later caller.
    with torch.no_grad():
        step(*args)
        program = torch.export.export(step, args, strict=False)
    return program, args


def write_serving_spec(path: str, model: InferenceModel,
                       params: Dict[str, Any], batch_size: int = 1,
                       device: DeviceLike = None):
    """Export the serving step (``export_step``) and write its
    ``step_spec.txt`` and ``state_init.bin`` into ``path``; returns the
    ``ExportedProgram``."""
    program, args = export_step(model, params, batch_size, device)
    with torch.no_grad():
        outs = program.module()(*args)
    _write_spec(os.path.join(path, "step_spec.txt"), model, args, outs)
    with open(os.path.join(path, "state_init.bin"), "wb") as f:
        for leaf in args[1:]:
            f.write(leaf.detach().cpu().contiguous().view(
                torch.uint8).numpy().tobytes())
    return program


def write_aoti_step(path: str, model: InferenceModel, params: Dict[str, Any],
                    batch_size: int = 1, device: DeviceLike = None):
    """Write ``step.pt2``, ``step_spec.txt`` and ``state_init.bin`` into
    the package at ``path`` (module docstring); returns the
    ``ExportedProgram`` that was compiled."""
    program = write_serving_spec(path, model, params, batch_size, device)
    step = os.path.join(path, STEP_FILE)
    if os.path.exists(step):
        os.remove(step)
    with torch.no_grad(), torch._inductor.config.patch(inductor_options()):
        torch._inductor.aoti_compile_and_package(program, package_path=step)
    return program


def inductor_options() -> Dict[str, Any]:
    """Inductor's settings for the serving step: the host compiler (one
    that links OpenMP, ``_build.host_cxx``), and float32 divisions
    rounded as eager's are (IEEE, ``div_rn``).  Triton's own division is
    approximate (``div.full``): on an H100 with torch 2.11 it put 3% of
    near-tie quotients on the other side of the tie, where the int8
    tier's quantization (``x / act_scale``, rounded half to even) must
    give eager's levels."""
    from joshupscale_torch.kernels._build import host_cxx

    return {"cpp.cxx": (host_cxx(),),
            "eager_numerics.division_rounding": True}


def _write_spec(path: str, model: InferenceModel, args, outs) -> None:
    """The reference's ``step_spec.txt`` for these example inputs and
    outputs: input 0 the frame, output 0 the display, and output 1+k
    aliasing input 1+k (the state)."""
    n_state = len(args) - 1
    if len(outs) != 1 + n_state or any(
            a.shape != o.shape or a.dtype != o.dtype
            for a, o in zip(args[1:], outs[1:])):
        raise AssertionError("state leaves are not self-aliasing")

    def line(kind, t):
        dims = ",".join(str(d) for d in t.shape)
        return f"{kind} {_SPEC_DTYPES[t.dtype]} {dims}"

    lines = ["joshupscale-step-spec 1",
             f"frame_height {model.frame_height}",
             f"frame_width {model.frame_width}",
             "scale 4"]
    lines += [line("input", t) for t in args]
    lines += [line("output", t) for t in outs]
    lines += [f"alias {1 + k} {1 + k}" for k in range(n_state)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_aoti_step(path: str) -> Callable:
    """Load a package's frozen ``step.pt2`` (the counterpart of the
    reference's ``load_stablehlo_step``): a callable ``(frame, *state) ->
    (display, *new_state)`` on the device it was compiled for; no model
    code or params are needed.  Its inputs must lie on that device."""
    step = os.path.join(path, STEP_FILE)
    if not os.path.exists(step):
        raise FileNotFoundError(
            f"{step} not found: write the package with "
            f"save_package(..., export_aoti=True)")
    loaded = torch._inductor.aoti_load_package(step)
    return lambda frame, *state: tuple(loaded(frame, *state))


def load_model_config(path: str) -> Dict[str, Any]:
    """The models of a YAML config file (a tier file, ``configs/*.yaml``):
    its ``models:`` entry, or the whole file where it has none."""
    import yaml  # only the package files need it

    with open(path) as f:
        doc = yaml.safe_load(f)
    return doc["models"] if "models" in doc else doc


def load_package(path: str) -> Tuple[InferenceModel, Dict[str, Any]]:
    """Load a package: returns ``(InferenceModel, params)``."""
    import yaml  # only the package files need it

    with open(os.path.join(path, "model.yaml")) as f:
        meta = yaml.safe_load(f)
    models = create_models(meta["models"], seed=0)
    built = models[meta.get("inference", "inference")]
    params = load_into(built.params,
                       load_params_npz(os.path.join(path, "params.npz")))
    return built.obj, params
