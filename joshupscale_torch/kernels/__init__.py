"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

- ``resblock.resblock_conv3x3`` (K1): fused res-block conv.
- ``display.d2s_display_u8`` (K2): depth_to_space(4) + uint8 display.
- ``probes.probe_dot`` (P1) and ``probes.probe_patch_dot`` (P2): the
  conv probe's product and patch-build kernels (``tools/conv_probe.py``).

Nothing is compiled at import; ``_build`` runs ``nvcc`` at first launch.
"""

from typing import Dict


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count so far, by wrapper name."""
    from joshupscale_torch.kernels.display import d2s_display_u8
    from joshupscale_torch.kernels.probes import probe_dot, probe_patch_dot
    from joshupscale_torch.kernels.resblock import resblock_conv3x3

    return {k.__name__: k.launches for k in (
        resblock_conv3x3, d2s_display_u8, probe_dot, probe_patch_dot)}
