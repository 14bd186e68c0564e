"""Sequential video stream with seek handling.

Port of ``joshupscale_tpu/runtime/stream.py`` over the port's
``Engine``.  Behavioral parity with the reference AviSynth filter
(reference ``avisynth_plugin/src/main.cc:75-157``): recurrent state
lives inside the runtime, so frames must be served in order; the stream

- serves monotone requests directly,
- backtracks up to ``max_backtrack`` frames by re-reading earlier source
  frames,
- on larger backward seeks (and forward jumps past ``max_backtrack``)
  resets the stream and re-warms the recurrent state with
  ``max_backtrack`` lead-in frames (the stream also opens with such a
  warm-up: the reference constructs with
  ``m_NextFrame = -MAX_BACKTRACK_SIZE``),
- MIRRORS negative lead-in indices (``child->GetFrame(n >= 0 ? n : -n)``,
  main.cc:110) so pre-stream warm-up frames carry real motion,
- keeps an LRU cache of the last ``max_backtrack`` outputs so small
  backward seeks are free -- but does NOT cache the ``max_backtrack``
  outputs produced right after a reset (``m_DontCache``, main.cc:150-157):
  they were computed from partially-warmed state, and serving them later
  would return visibly degraded frames.
"""

from __future__ import annotations

import collections
from typing import Callable, Optional

import numpy as np

from joshupscale_torch.runtime.engine import Engine

MAX_BACKTRACK = 16


class VideoStream:
    """Order-enforcing frame server over an Engine.

    Parameters
    ----------
    engine : the recurrent engine (batch_size 1).
    source : callable(frame_index) -> (H, W, 3) uint8.  Always called
        with a non-negative index: warm-up lead-ins before frame 0 are
        mirrored (index ``-n``), clamped to ``num_frames - 1`` when the
        stream length is known.
    num_frames : optional stream length for validation.
    """

    def __init__(
        self,
        engine: Engine,
        source: Callable[[int], np.ndarray],
        num_frames: Optional[int] = None,
        max_backtrack: int = MAX_BACKTRACK,
    ) -> None:
        self.engine = engine
        self.source = source
        self.num_frames = num_frames
        self.max_backtrack = max_backtrack
        # The stream OPENS in a warm-up window, like the reference's
        # m_NextFrame = -MAX_BACKTRACK_SIZE construction: frame 0 is
        # served with real (mirrored) motion lead-in.
        self._next_frame = -max_backtrack
        self._dont_cache = max_backtrack
        self._cache: "collections.OrderedDict[int, np.ndarray]" = (
            collections.OrderedDict())

    def reset(self, start_frame: int = 0) -> None:
        """Restart the stream; state re-warms from ``max_backtrack``
        lead-in frames before ``start_frame`` (their outputs uncached)."""
        self.engine.reset()
        self._cache.clear()
        self._next_frame = start_frame - self.max_backtrack
        self._dont_cache = self.max_backtrack

    def get_frame(self, n: int) -> np.ndarray:
        """Return upscaled frame ``n``, enforcing sequential recurrence."""
        if self.num_frames is not None and not 0 <= n < self.num_frames:
            raise IndexError(f"Frame {n} out of range")
        if n < self._next_frame:
            if n in self._cache:
                self._cache.move_to_end(n)
                return self._cache[n]
            # Large backward seek: replay warm-up.
            self.reset(n)
        elif n - self._next_frame > self.max_backtrack:
            # Large forward jump: skip ahead, re-warm from n - backtrack.
            self.reset(n)
        while self._next_frame < n:
            self._process(self._next_frame)
        return self._process(n)

    def _process(self, n: int) -> np.ndarray:
        idx = -n if n < 0 else n  # mirrored warm-up (reference :110)
        if self.num_frames is not None:
            idx = min(idx, self.num_frames - 1)
        out = self.engine.process(self.source(idx))
        self._next_frame = n + 1
        if self._dont_cache > 0:
            # Warm-up output: partially-warmed state, never cached
            # (reference m_DontCache, main.cc:150-157).
            self._dont_cache -= 1
        else:
            self._cache[n] = out
            while len(self._cache) > self.max_backtrack:
                self._cache.popitem(last=False)
        return out
