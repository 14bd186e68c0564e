"""Command-line tools of the port that run on the card.

- ``conv_probe``: times the conv probe's kernels (P1, P2) and cuDNN's
  conv at the res-block conv's shape.
- ``timing``: device-only kernel timing with CUDA events.
"""
