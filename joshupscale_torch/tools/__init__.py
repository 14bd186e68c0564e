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
calibration and quality tools share.

The model-quality tools, each the port of ``tools/<name>.py``:
``make_synth_dataset`` (the synthetic pan / zoom video set, PNG or
TFRecords) and ``keras_vgg_to_npz`` (Keras VGG19 h5 weights to the
perceptual loss's npz) on the host; ``bn_recalibrate`` (moving
statistics from the training forward), ``eval_synth`` (held-out PSNR
against bilinear x4, VGG distance, ping-pong L1), ``eval_serving_fullres``
(the same at 480x270), ``drift_1000`` (u8 state against float state and
stream against clip over 1000 frames) and ``gan_soak`` (the full-width
GAN step's loss path) on the card unless ``--cpu``; ``learning_run``
chains them into the learning protocol (render, train, recalibrate,
evaluate).

The measurement tools, each the port of ``tools/<name>.py`` (the card,
or ``--cpu --tiny`` to rehearse on the CPU, every number then labelled
``cpu``): ``run_native`` (frames through the C++ host's ``upscale_cli``,
ms a frame from outside the process beside the artifact's device time),
``profile_step`` (a replayed serving step's device ops by part),
``serving_check`` (full frames, stream against clip), ``latency_probe``
(device and ``Engine.process`` p50 / p90 / p99), ``pipeline_probe``
(``PipelinedEngine``'s two stages), ``train_step_bench``,
``profile_train_step``, ``fit_overlap_bench`` and ``fit_cost_probe``
(train steps, their device ops and ``fit``'s host costs).
"""
