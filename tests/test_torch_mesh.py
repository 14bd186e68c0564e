"""The data-parallel mesh for training (``joshupscale_torch.parallel.mesh``,
``mesh=`` on the FRVSR and GAN steps, ``fit`` and the CLI's
``--num-devices``) on 2 CPU ranks under gloo.

The contract is the reference's (``joshupscale_tpu/parallel/mesh.py``):
the sharded step is the one-process step on the global batch.  Each
check runs the same params, global batch and noise through the port's
step on 2 spawned ranks and in this process (``tools.mesh_parity``,
whose rank function the spawned ranks import: they import the port
only), and one holds the ranks' gradient against the JAX step on a
2-device CPU mesh.  The ranks run torch on one thread
(``OMP_NUM_THREADS=1``); one launch serves the FRVSR, K = 2 and GAN
runs.

Bounds (float32; sharding reorders the sums): gradients within 1e-5
relative L2 of the one-process step's, the loss, metrics and moving
statistics within rtol 1e-5, the params within ``2 * lr * steps`` +
1e-6 (Adam moves a param by at most about ``lr`` a step, also where
round-off flips the sign of a near-zero gradient), the ranks' params
bit for bit.  Against JAX: each gradient within 5e-4 relative L2 and
the loss within rtol 5e-4 (``tests/test_training.py``'s data-parallel
bound).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from joshupscale_tpu.export.importer import flatten_params
from joshupscale_tpu.models import create_models as j_create_models
from joshupscale_tpu.parallel.mesh import (
    create_mesh as j_create_mesh,
    replicate as j_replicate,
    shard_batch as j_shard_batch,
)
from joshupscale_tpu.training import (
    TrainState as JTrainState,
    build_frvsr_step as j_build_step,
)
from joshupscale_torch.export.weights import to_flat_numpy
from joshupscale_torch.parallel.mesh import (
    Mesh,
    batch_spec,
    check_backend,
    launch,
    local_batch,
    mesh_devices,
    shard_batch,
)
from joshupscale_torch.tools import mesh_parity as mp

B, T, CROP, STEPS, LR = 4, 4, 8, 2, 5e-4
# The GAN unrolls T = 10 frames; a small learning rate keeps the second
# step's inputs (the first step's params) close: Adam's first step
# moves every param by about lr, whichever way round-off turns a
# near-zero gradient.
GAN_LR = 1e-5
RTOL = 1e-5
JAX_RTOL = 5e-4
GEN_LOSS_RTOL = 2e-3  # tests/test_full_arch_multichip.py


def _models(**frvsr):
    models = mp.frvsr_models((8, 1), (8, 1), lr=LR)
    models["frvsr"].update(frvsr)
    return models


def _batch(rng, b=B, t=T, crop=CROP):
    """u8 frames with saturated rows (0 and 255), as
    ``tests/test_torch_training.py`` makes them."""
    inp = rng.integers(0, 256, (b, t, crop, crop, 3), dtype=np.uint8)
    tgt = rng.integers(0, 256, (b, t, 4 * crop, 4 * crop, 3),
                       dtype=np.uint8)
    inp[:, :, :2] = 255
    inp[:, :, -1] = 0
    tgt[:, :, :5] = 255
    tgt[:, :, -5:] = 0
    return {"input": inp, "target": tgt}


def _j_noise(key, b=B, t=T, crop=CROP):
    """The reference FRVSR step's draws for ``key``."""
    k_hist, k_first = jax.random.split(key)
    return {"first_warp": np.array(jax.random.uniform(
        k_first, (b, 4 * crop, 4 * crop, 3), jnp.float32, -0.5, 0.5)),
        "history": np.array(jax.random.uniform(
            k_hist, (b, 2, crop, crop, 3), jnp.float32, -0.5, 0.5))}


def _j(batch):
    return {k: jnp.asarray(v.astype(np.float32) / np.float32(255)
                           - np.float32(0.5)) for k, v in batch.items()}


KEY = jax.random.PRNGKey(3)


@pytest.fixture(scope="module")
def runs():
    """The FRVSR run (the reference's params carried across, its draws
    as the first step's noise), the same FRVSR at K = 2 and the GAN,
    each on 2 CPU ranks (one launch) and in this process."""
    rng = np.random.default_rng(0)
    config = _models()
    j_built = j_create_models(config)["frvsr"]
    frvsr = mp.make_run(config, "frvsr", B, T, CROP, STEPS)
    frvsr.batches = [_batch(rng) for _ in range(STEPS)]
    frvsr.noises[0] = _j_noise(KEY)
    frvsr.params = flatten_params(j_built.params)
    k2 = mp.make_run(config, "frvsr", B, T, CROP, STEPS,
                     steps_per_execution=2)
    gan = mp.make_run(mp.frvsr_models((8, 1), (8, 1), gan=True, lr=GAN_LR),
                      "gan", B, 10, CROP, STEPS)
    todo = {"frvsr": frvsr, "k2": k2, "gan": gan}
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("OMP_NUM_THREADS", "1")
        meshed = launch(mp.run_many, 2, list(todo.values()),
                        devices=["cpu", "cpu"])
    return {name: (r, mp.run_steps(None, r, "cpu"), m)
            for (name, r), m in zip(todo.items(), meshed)}


def _check_frvsr(one, meshed, steps):
    assert len(meshed["grads"]) == len(one["grads"]) == steps
    for g1, gm in zip(one["grads"], meshed["grads"]):
        assert set(g1) == set(gm)
        for p in g1:
            assert mp.rel_l2(gm[p], g1[p]) <= RTOL, p
    for m1, mm in zip(one["metrics"], meshed["metrics"]):
        for name in m1:
            np.testing.assert_allclose(mm[name], m1[name], rtol=RTOL)
    for p, v in one["params"].items():
        if p.endswith(("moving_mean", "moving_variance")):
            np.testing.assert_allclose(meshed["params"][p], v, rtol=RTOL,
                                       atol=1e-7, err_msg=p)
        else:
            assert np.abs(meshed["params"][p] - v).max() <= (
                2 * LR * steps + 1e-6), p
    assert meshed["steps"] == one["steps"] == steps
    assert len(meshed["digests"]) == 2
    assert meshed["digests"][0] == meshed["digests"][1]


def test_frvsr_mesh_step_is_the_one_process_step(runs):
    """2 ranks against one process on the same global batch, 2 steps:
    the all-reduced gradients, the metrics, the moving statistics and
    the params; the ranks' params bit for bit."""
    _, one, meshed = runs["frvsr"]
    _check_frvsr(one, meshed, STEPS)
    # The moving statistics moved (global-batch moments were taken).
    assert np.abs(meshed["params"]["flow.bn_1.moving_mean"]).max() > 0


def test_frvsr_mesh_step_matches_the_jax_mesh_step(runs):
    """The ranks' first gradient (all-reduced) and loss against the
    reference's step on a 2-device CPU mesh, from the same params, batch
    and draws; the reference's gradient read as ``(p0 - p1) / lr``
    through ``optax.sgd(lr)`` (lr = 1: the difference keeps the
    gradient's float32 digits)."""
    run, _, meshed = runs["frvsr"]
    j_built = j_create_models(run.models)["frvsr"]
    opt = optax.sgd(1.0)
    mesh = j_create_mesh(2)
    params = j_replicate(mesh, jax.tree_util.tree_map(jnp.array,
                                                      j_built.params))
    before = {k: np.array(v) for k, v in flatten_params(params).items()}
    state = JTrainState(params, j_replicate(mesh, opt.init(params)),
                        j_replicate(mesh, jnp.zeros((), jnp.int32)))
    step = j_build_step(j_built.obj, opt, mesh=mesh)
    state, metrics = step(state, j_shard_batch(mesh, _j(run.batches[0])),
                          KEY)
    after = flatten_params(state.params)
    np.testing.assert_allclose(meshed["metrics"][0]["loss"],
                               float(metrics["loss"]), rtol=JAX_RTOL)
    got = meshed["grads"][0]
    for p, g in got.items():
        want = (before[p].astype(np.float64) - after[p]) / 1.0
        assert mp.rel_l2(g, want) <= JAX_RTOL, (p, mp.rel_l2(g, want))
    assert any(np.any(g) for g in got.values())


def test_frvsr_mesh_steps_per_execution(runs):
    """K = 2 optimizer steps an execution on the mesh (axis 1 of the
    (K, B, ...) batch sharded) against the same in one process."""
    run, one, meshed = runs["k2"]
    assert run.batches[0]["input"].shape[:2] == (2, B)
    _check_frvsr(one, meshed, 2 * STEPS)


def test_gan_mesh_step_takes_the_one_process_decisions(runs):
    """The GAN step on 2 ranks against one process, 2 steps: the same
    gate decisions, the EMAs (the first step's to round-off; the
    second's within 1e-5, the first step's Adam update apart), gen_loss
    within 2e-3, the ranks' params bit for bit."""
    _, one, meshed = runs["gan"]
    assert meshed["gates"] == one["gates"]
    np.testing.assert_allclose(meshed["emas"][0], one["emas"][0],
                               atol=1e-7)
    np.testing.assert_allclose(meshed["emas"], one["emas"], atol=1e-5)
    for m1, mm in zip(one["metrics"], meshed["metrics"]):
        np.testing.assert_allclose(mm["gen_loss"], m1["gen_loss"],
                                   rtol=GEN_LOSS_RTOL)
        assert mm["discr_steps"] == m1["discr_steps"]
    assert meshed["digests"][0] == meshed["digests"][1]


def test_shard_batch_splits_evenly_or_raises():
    """Each rank's slice of the leading axis (axis 1 under K > 1); a
    batch the world size does not divide raises."""
    x = np.arange(2 * 6 * 3).reshape(2, 6, 3)
    for rank in (0, 1, 2):
        mesh = Mesh(rank, 3, ("data",), torch.device("cpu"),
                    (torch.device("cpu"),) * 3, "gloo")
        part = shard_batch(mesh, {"a": x[0]})["a"]
        np.testing.assert_array_equal(part.numpy(), x[0, 2 * rank:
                                                      2 * rank + 2])
        stacked = local_batch(mesh, {"a": x}, batch_spec(mesh, 2))["a"]
        np.testing.assert_array_equal(stacked, x[:, 2 * rank:2 * rank + 2])
    assert batch_spec(mesh) == ("data",)
    assert batch_spec(mesh, 2) == (None, "data")
    with pytest.raises(ValueError, match="does not split"):
        local_batch(mesh, {"a": np.zeros((4, 2))})


def test_backend_pairings():
    """The backend is explicit: nccl for distinct CUDA devices, gloo for
    the CPU and for ranks sharing a card; a pairing the backend cannot
    serve raises, before any rank starts."""
    assert check_backend(["cpu", "cpu"]) == "gloo"
    assert check_backend(["cuda:0", "cuda:0"]) == "gloo"
    assert check_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert check_backend([0, "cuda"], "gloo") == "gloo"
    for devices, backend, match in (
            (["cpu", "cpu"], "nccl", "CUDA tensors only"),
            (["cuda:0", "cuda"], "nccl", "one device"),
            (["cpu", "cuda:0"], None, "all CPU or all CUDA"),
            (["cpu", "cpu"], "mpi", "unknown backend")):
        with pytest.raises(ValueError, match=match):
            check_backend(devices, backend)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        launch(mp.run_many, 2, [], devices=["cpu", "cpu"], backend="nccl")
    with pytest.raises(ValueError, match="CUDA devices asked for"):
        mesh_devices(torch.cuda.device_count() + 1)


def _write_sequences(root, groups, seed, h=12, w=12):
    """``groups`` ten-frame PNG sequences under ``root/{lr,hr}``."""
    import cv2

    rng = np.random.default_rng(seed)
    for sub in ("lr", "hr"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for g in range(groups):
        for i in range(10):
            hr = rng.integers(0, 256, (4 * h, 4 * w, 3), dtype=np.uint8)
            lr = hr.reshape(h, 4, w, 4, 3).mean((1, 3)).astype(np.uint8)
            name = f"seq{g:02d}_{i:02d}.png"
            cv2.imwrite(os.path.join(root, "lr", name), lr)
            cv2.imwrite(os.path.join(root, "hr", name), hr)


def test_training_cli_on_two_cpu_ranks(tmp_path, capfd, monkeypatch):
    """``--cpu --num-devices 2`` through the training CLI: rank 0 alone
    logs and writes the checkpoints, which load into the one-process
    template; the history (train and validation losses, global-batch
    means) and the params match the one-process CLI on the same config
    and seed.  More CUDA devices than exist raise."""
    import yaml

    from joshupscale_torch.training import cli, load_checkpoint

    _write_sequences(str(tmp_path / "train"), 2, 0)
    _write_sequences(str(tmp_path / "val"), 1, 1)

    def chain(root):
        return [{"name": "LocalDatasetOp",
                 "lr_path": str(tmp_path / root / "lr" / "*.png"),
                 "hr_path": str(tmp_path / root / "hr" / "*.png")},
                {"name": "RandomCropOp", "crop_size": CROP, "num_img": 2}]

    def config(ckpt):
        return {"models": _models(),
                "train_dataset": chain("train") + [{"name": "RepeatOp"}],
                "val_dataset": chain("val"),
                "train": {"model": "frvsr", "batch_size": 2, "epochs": 2,
                          "steps_per_epoch": 2, "val_size": 2,
                          "checkpoint_dir": str(tmp_path / ckpt),
                          "tensorboard": False}}

    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(config("ranks")))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert cli.main(["-c", str(path), "--cpu", "--num-devices", "2"]) == 0
    out = capfd.readouterr().out
    assert "data-parallel mesh over 2 devices" in out
    assert out.count("epoch 1:") == 1
    # The config as the ranks read it (the YAML's key order is the
    # registry's build order, and so its draws).
    same = yaml.safe_load(path.read_text())
    same["train"]["checkpoint_dir"] = str(tmp_path / "one")
    assert cli.train(same, device="cpu") == 0

    ranks, one = tmp_path / "ranks", tmp_path / "one"
    assert sorted(os.listdir(ranks)) == ["best.npz", "history.json",
                                         "latest.npz"]
    template = cli.build_training(same, device="cpu").state
    got = load_checkpoint(str(ranks / "latest.npz"), template.tree())
    want = load_checkpoint(str(one / "latest.npz"), template.tree())
    assert got["step"] == want["step"] == 4
    # From the second step on, the replicas' params are the one-process
    # params within Adam's bound, and so are the moving statistics
    # they produce.
    got_flat = to_flat_numpy(got["params"])
    for p, v in to_flat_numpy(want["params"]).items():
        assert np.abs(got_flat[p] - v).max() <= 2 * LR * 4 + 1e-6, p
    h_ranks = json.loads((ranks / "history.json").read_text())
    h_one = json.loads((one / "history.json").read_text())
    assert len(h_ranks) == len(h_one) == 2
    for a, b in zip(h_ranks, h_one):
        for k in ("train_loss", "val_loss", "val_target_warp_loss"):
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL, err_msg=k)

    with pytest.raises(ValueError, match="CUDA devices asked for"):
        cli.train(config("none"), num_devices=torch.cuda.device_count() + 2)


def test_a_failing_rank_fails_the_launch(monkeypatch):
    """A rank that raises (here: a global batch of 3 for 2 ranks) fails
    the launch with its error; no result comes back."""
    run = mp.make_run(_models(), "frvsr", 3, 2, 4, 1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with pytest.raises(Exception, match="does not split"):
        launch(mp.run_steps, 2, run, devices=["cpu", "cpu"])
