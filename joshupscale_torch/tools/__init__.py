"""Command-line tools of the port that run on the card.

- ``conv_probe``: times the conv probe's kernels (P1, P2) and cuDNN's
  conv at the res-block conv's shape.
- ``timing``: device-only kernel timing with CUDA events.
- ``ab_quality_step``: the quality tier's replayed step of one checkout,
  to compare two commits in turns within one call.
- ``mesh_parity``: the data-parallel train step on a mesh of ranks
  against the one-process step.

The package tools, each the port of ``tools/<name>.py`` (the card
unless ``--cpu``): ``generate_calibration`` and
``calibration_fidelity`` (int8 ranges, the three calibrators against
the bf16 engine), ``onnx_to_npz`` / ``npz_to_onnx`` (weights out of and
into an ONNX graph), ``onnx_verify`` (export a package, run the graph
against ``Engine``), ``upscale_images`` (an image sequence through a
package or its ``--onnx`` graph) and ``make_model_set`` (the OBS
plugin's four packages and mask); ``val_data`` holds what the
calibration tools share.
"""
