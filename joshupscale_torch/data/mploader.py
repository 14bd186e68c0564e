"""Multiprocess batch loader with shared-memory transport.

The port of ``joshupscale_tpu/data/mploader.py``: the host-side analog
of tf.data's parallel C++ op chain (reference
``scripts/training/dataset.py:496-607`` runs its map/interleave ops on
a thread pool of C++ kernels outside the GIL).  Worker PROCESSES each
run a full pipeline replica over a disjoint shard of the source and
stream finished batches to the trainer through POSIX shared memory --
one memcpy per side, no pickling through pipes.

- Workers never touch the card: they start with
  ``CUDA_VISIBLE_DEVICES=""`` (``_HiddenCardEnv``), so a worker that
  imports torch sees no CUDA device, and they are always started by
  ``spawn`` -- a ``fork`` of a parent that already holds a CUDA context
  gives the child a context it cannot use.
- Ordering is deterministic: the parent round-robins workers
  (batch k comes from worker ``k % num_workers``), and each worker's
  stream is a pure function of its spawned seed, so a seeded run
  reproduces the exact batch stream for a fixed ``num_workers`` -- the
  JAX package's loader's stream, for the same config and seed.
- Each batch rides one SharedMemory segment created by the worker and
  unlinked by the parent after copy-out; the worker unregisters its
  handle from its resource tracker so ownership transfers cleanly
  (no double-unlink warnings, no leaked segments on clean exit).
- A worker that exhausts its shard sends DONE and exits; the parent
  drops it from the rotation.  Worker exceptions are forwarded with
  their traceback and re-raised in the parent.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import queue as queuelib
import threading
import traceback
from multiprocessing import shared_memory
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np

# Serializes os.environ mutation around Process.start() (see
# _HiddenCardEnv).
_ENV_LOCK = threading.Lock()

_DONE = "done"
_DATA = "data"
_ERROR = "error"


@dataclasses.dataclass(frozen=True)
class WorkerInfo:
    """Identity handed to a batch-source factory inside a worker.

    ``seed`` is this worker's privately spawned seed (distinct per
    worker).  ``root_seed`` is the loader-level seed, IDENTICAL across
    all workers of one loader: a factory that shards a shuffled source
    must seed the source from ``root_seed`` (so every worker sees the
    same source order and the strided shards are disjoint) and may use
    ``seed``/the shard index for everything downstream.  Always set --
    an unseeded loader draws one random root in the parent so sharding
    stays correct.
    """

    index: int
    num_workers: int
    seed: Optional[int]
    root_seed: int = 0


def _unregister_shm(shm: shared_memory.SharedMemory) -> None:
    """Transfer unlink responsibility for ``shm`` to the other process."""
    try:  # pragma: no cover - resource_tracker is CPython internal
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass


def _pack(batch: Dict[str, np.ndarray]):
    """Copy a dict of arrays into one fresh SharedMemory segment."""
    arrays = {k: np.asarray(v) for k, v in batch.items()}
    total = sum(v.nbytes for v in arrays.values())
    shm = shared_memory.SharedMemory(create=True, size=max(total, 1))
    meta = []
    offset = 0
    for k, v in arrays.items():
        view = np.frombuffer(shm.buf, dtype=v.dtype, count=v.size,
                             offset=offset).reshape(v.shape)
        np.copyto(view, v)
        del view  # release the exported buffer before close()
        meta.append((k, v.shape, v.dtype.str, offset))
        offset += v.nbytes
    name = shm.name
    _unregister_shm(shm)  # parent will unlink
    shm.close()
    return name, meta


def _unpack(name: str, meta) -> Dict[str, np.ndarray]:
    """Copy arrays out of a segment, then unlink it."""
    shm = shared_memory.SharedMemory(name=name)
    try:
        out = {}
        for k, shape, dtype, offset in meta:
            count = int(np.prod(shape, dtype=np.int64))
            n = count * np.dtype(dtype).itemsize
            if offset + n > shm.buf.nbytes:
                raise ValueError(
                    f"shm segment {name!r} too small for {k}: need "
                    f"{offset + n} bytes, have {shm.buf.nbytes}")
            arr = np.frombuffer(
                shm.buf, dtype=dtype, count=count, offset=offset,
            ).reshape(shape)
            out[k] = np.array(arr)  # own the memory before unlink
            del arr
        return out
    finally:
        shm.close()
        shm.unlink()


def _worker_main(factory, info: WorkerInfo, out_queue, cancel) -> None:
    """Worker process body: run the pipeline, stream packed batches."""
    try:
        for batch in factory(info):
            if not isinstance(batch, dict):
                raise TypeError(
                    "mploader factories must yield dicts of numpy "
                    f"arrays, got {type(batch).__name__}")
            name, meta = _pack(batch)
            while not cancel.is_set():
                try:
                    out_queue.put((_DATA, name, meta), timeout=0.1)
                    break
                except queuelib.Full:
                    continue
            else:
                # Consumer gone: reclaim the unsent segment ourselves
                # (attach registers with the tracker, unlink
                # unregisters -- balanced, no extra unregister here).
                shm = shared_memory.SharedMemory(name=name)
                shm.close()
                shm.unlink()
                return
        out_queue.put((_DONE, None, None))
    except BaseException:
        try:
            out_queue.put((_ERROR, traceback.format_exc(), None))
        except Exception:
            pass


class _HiddenCardEnv:
    """Hide the CUDA devices from worker interpreters.

    ``spawn`` children inherit ``os.environ`` at start(); with
    ``CUDA_VISIBLE_DEVICES`` empty a worker that imports torch finds no
    device, so a data worker can neither create a CUDA context nor
    take memory on the card.  The parent env is restored immediately
    after the processes start (the parent's own CUDA state is fixed at
    its first CUDA call, so the brief change does not reach it unless
    that call lands inside the window).

    ``multiprocessing.Process`` has no per-child env, so mutating the
    process-global environ around start() is the only lever; a module
    lock serializes concurrent spawns; any OTHER thread that launches a
    card-needing subprocess during the brief start() window should pass
    an explicit ``env=`` to it instead of inheriting.
    """

    _KEY = "CUDA_VISIBLE_DEVICES"

    def __enter__(self):
        _ENV_LOCK.acquire()
        self._saved = os.environ.get(self._KEY)
        os.environ[self._KEY] = ""
        return self

    def __exit__(self, *exc):
        try:
            if self._saved is None:
                os.environ.pop(self._KEY, None)
            else:
                os.environ[self._KEY] = self._saved
        finally:
            _ENV_LOCK.release()
        return False


class MultiprocessLoader:
    """Iterable running ``factory`` in ``num_workers`` processes.

    ``factory(info: WorkerInfo) -> Iterable[Dict[str, np.ndarray]]``
    must be picklable (a module-level callable or instance).  Batches
    are yielded in deterministic round-robin worker order.  Iterating
    creates a fresh set of workers each pass; generator ``close()``
    shuts the workers down.

    Standard multiprocessing-spawn caveat: the program creating a
    loader must be import-safe (construction under
    ``if __name__ == "__main__":`` in scripts) — spawn re-imports the
    main module in each worker.
    """

    def __init__(self, factory: Callable[[WorkerInfo], Iterable],
                 num_workers: int, seed: Optional[int] = None,
                 prefetch: int = 2):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self.factory = factory
        self.num_workers = int(num_workers)
        self.seed = seed
        self.prefetch = max(int(prefetch), 1)

    def _spawn(self):
        ctx = mp.get_context("spawn")
        cancel = ctx.Event()
        seeds = ([None] * self.num_workers if self.seed is None else
                 [int(s.generate_state(1)[0]) for s in
                  np.random.SeedSequence(self.seed).spawn(self.num_workers)])
        # The shared root: even an unseeded loader needs ONE source
        # order common to all workers (see WorkerInfo.root_seed), so
        # draw a random root in the parent when no seed was given.
        root = (self.seed if self.seed is not None
                else int(np.random.SeedSequence().generate_state(1)[0]))
        queues = [ctx.Queue(maxsize=self.prefetch)
                  for _ in range(self.num_workers)]
        procs = []
        with _HiddenCardEnv():
            for i in range(self.num_workers):
                info = WorkerInfo(i, self.num_workers, seeds[i], root)
                p = ctx.Process(
                    target=_worker_main,
                    args=(self.factory, info, queues[i], cancel),
                    daemon=True,
                )
                p.start()
                procs.append(p)
        return procs, queues, cancel

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        procs, queues, cancel = self._spawn()
        alive = list(range(self.num_workers))
        pos = 0  # index into `alive`: the worker owed the next batch
        try:
            while alive:
                widx = alive[pos]
                proc = procs[widx]
                while True:
                    try:
                        kind, a, b = queues[widx].get(timeout=1.0)
                        break
                    except queuelib.Empty:
                        if not proc.is_alive():
                            raise RuntimeError(
                                f"data worker {widx} died "
                                f"(exitcode {proc.exitcode})") from None
                if kind == _ERROR:
                    raise RuntimeError(f"data worker {widx} failed:\n{a}")
                if kind == _DONE:
                    alive.pop(pos)
                    if alive:
                        pos %= len(alive)  # rotation continues at next
                    continue
                yield _unpack(a, b)
                pos = (pos + 1) % len(alive)
        finally:
            cancel.set()

            def drain():
                for q in queues:
                    while True:
                        try:
                            kind, a, b = q.get_nowait()
                        except (queuelib.Empty, OSError):
                            break  # queue empty or unreadable
                        if kind != _DATA:
                            continue
                        try:
                            _unpack(a, b)  # copy-out + unlink
                        except OSError:
                            # One segment vanished (e.g. a terminate()d
                            # worker mid-put); the REST of this queue's
                            # segments still need unlinking -- aborting
                            # here would leak them all in /dev/shm.
                            continue

            drain()  # unblock workers stuck on a full queue
            for p in procs:
                p.join(timeout=5.0)
                if p.is_alive():  # pragma: no cover - stuck worker
                    p.terminate()
                    p.join(timeout=5.0)
            # Second drain AFTER the joins: a worker's final put() can
            # complete between the first drain and its exit (mp.Queue
            # hands items to a feeder thread, so put() returning does
            # not mean the parent could see it yet).  The worker already
            # transferred unlink responsibility for that segment to us;
            # missing it here would leak the /dev/shm segment until
            # reboot.  After join the feeder threads have flushed, so
            # this pass sees everything that was ever sent.
            drain()
            for q in queues:
                q.close()


class ConfigPipelineFactory:
    """Picklable factory: build a config pipeline shard in a worker.

    Each worker runs ``create_dataset(config, seed=info.root_seed,
    shard=(num_workers, index))`` followed by the trailing ops (batch).
    The ROOT seed is shared across workers, which is what makes the
    shards one exact pass over the source: create_dataset seeds the
    source op identically everywhere (one shared shuffle order;
    strided shards disjoint) and re-spawns every downstream op's
    generator by shard index (decorrelated augmentation draws).
    """

    def __init__(self, config, batch_size: Optional[int] = None):
        self.config = config
        self.batch_size = batch_size

    def __call__(self, info: WorkerInfo):
        from joshupscale_torch.data.pipeline import create_dataset

        config = list(self.config)
        if self.batch_size is not None:
            config = config + [
                {"name": "BatchOp", "batch_size": self.batch_size}
            ]
        return create_dataset(
            config, seed=info.root_seed,
            shard=(info.num_workers, info.index),
        )
