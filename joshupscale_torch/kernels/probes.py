"""P1 and P2: the conv probe's two kernels, with their plain versions.

Source note.  The conv probe (``joshupscale_torch/tools/conv_probe.py``)
splits the res-block conv's cost (K1) into its parts at K1's shape,
270 x 480 positions of 64 channels:

- P1 ``probe_dot`` replaces ``tools/pallas_conv_probe.py probe_dot`` ->
  ``kernel``: the product alone, ``bf16(A_blk @ B)`` with A (M, 576)
  and B (576, N).  CUDA source ``csrc/probe_dot.cu``, on the Hopper core
  of ``csrc/wgmma_tma.cuh``: TMA brings every operand into shared memory
  in 128-byte swizzled boxes and ``wgmma`` multiplies them there.  Bound
  by operations with A resident (9.7 us for N = 64 on an H100), by bytes
  with A streamed (149 MB of A, about 49 us).  Resident mode keeps A_blk
  in shared memory, spread over the CTAs, as the TPU kernel keeps it in
  VMEM: it times the product with no operand traffic.  Streamed mode
  pipelines A through a TMA ring while B stays resident.
- P2 ``probe_patch_dot`` replaces ``tools/pallas_conv_probe.py
  probe_patch_dot`` -> ``kernel``: the 9-tap patch of a flat padded
  buffer times the (576, 64) weights, relu, and with ``pair`` the second
  product and the residual add of a res block.  CUDA source
  ``csrc/probe_patch_dot.cu``, on the same core: each CTA holds the x
  rows of its row chunk (three dy windows, and the pair's residual
  rows) and the weights in shared memory and computes every step's
  products from them, the taps as shifts of the A descriptor; the
  pair's first product stays in registers as the ``wgmma`` A operand
  of the second.  Bound by operations (9.5 us, 19.1 us for the pair).

Both sources say how their design meets that bound.  TMA takes operands
whose base addresses are multiples of 16 bytes.  The functions keep
what the Pallas calls compute, quirks included: in resident mode every
output tile of P1 is the same, and every step of P2 reads the same input
rows.  The JAX call leaves rows undefined where ``tile_m`` does not
divide M; ``probe_dot`` raises instead.

``probe_dot`` and ``probe_patch_dot`` launch the kernels for CUDA
tensors and run the plain versions for CPU tensors; there is no fallback
from one to the other.  Each counts its kernel launches in
``.launches``.  ``probe_dot_bound``, ``probe_patch_dot_bound`` and
``pair_tail_bound`` give how far two correct evaluations may differ,
element by element.
"""

from __future__ import annotations

import ctypes

import torch

from joshupscale_torch.kernels import _build

M = 129600             # 270 x 480 positions
K = 576                # 3 x 3 taps x 64 channels
C = 64
PW = 482               # padded row width of P2's flat buffer
HALO = 2 * PW + 2      # flat offset of tap (2, 2)
DOT_WIDTHS = (64, 128)
DOT_K_STEP = 64        # P1's k-chunk: K must be a multiple, up to 576


def _entry(name: str, argtypes) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, its entry point ``jt_<name>``
    typed (assigning the types again is harmless)."""
    lib = _build.load(name)
    fn = getattr(lib, f"jt_{name}")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib


def _require_kernel_operands(tensors) -> None:
    """A CUDA launch takes contiguous, 16-byte aligned operands."""
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("operands must be contiguous and 16-byte "
                             "aligned")


def _on_device(tensors, what: str) -> str:
    """'cpu' or 'cuda': the device type all operands share."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: all operands must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev.type


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 numbers at |t|, as float32 (that of the
    smallest normal below it)."""
    a = t.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    _, e = torch.frexp(a)  # a = m * 2**e, m in [0.5, 1)
    return torch.ldexp(torch.ones_like(a), e - 8)


def _reorder_slack(k: int, abs_sum: torch.Tensor) -> torch.Tensor:
    """The largest difference two f32 summation orders of ``k`` exact
    terms can make, given the sum of their magnitudes: 2(k-1)u|.|, u =
    2**-24, taken as k 2**-23 |.|."""
    return abs_sum * (k * 2.0 ** -23)


# ----------------------------------------------------------------- P1


def _check_dot(a, b, tile_m):
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"probe_dot takes 2-D A and B, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    m, k = a.shape
    if b.shape[0] != k or b.shape[1] not in DOT_WIDTHS:
        raise ValueError(f"B must be ({k}, N) with N in {DOT_WIDTHS}, got "
                         f"{tuple(b.shape)}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"probe_dot takes bfloat16, got {a.dtype}, "
                        f"{b.dtype}")
    if k % DOT_K_STEP or not 0 < k <= K:
        raise ValueError(f"K must be a multiple of {DOT_K_STEP} up to {K}, "
                         f"got {k}")
    if tile_m < 1 or m % tile_m:
        raise ValueError(f"tile_m {tile_m} must divide M {m} (the TPU call "
                         f"leaves the rows past the last whole tile "
                         f"undefined)")
    return _on_device([a, b], "probe_dot")


def probe_dot_plain(a: torch.Tensor, b: torch.Tensor, tile_m: int,
                    resident: bool = True) -> torch.Tensor:
    """The plain PyTorch version: the f32 product of the (exactly
    widened) operands, one rounding to bfloat16."""
    _check_dot(a, b, tile_m)
    if not resident:
        return (a.float() @ b.float()).to(torch.bfloat16)
    y = (a[:tile_m].float() @ b.float()).to(torch.bfloat16)
    return y.repeat(a.shape[0] // tile_m, 1)


def probe_dot(a: torch.Tensor, b: torch.Tensor, tile_m: int,
              resident: bool = True) -> torch.Tensor:
    """(M, N) bf16: output tile i (rows [i tile_m, (i+1) tile_m)) is
    ``bf16(A_blk @ B)``, f32 accumulation, with ``A_blk = A[:tile_m]``
    when ``resident`` and ``A[i tile_m:(i+1) tile_m]`` otherwise.

    a: (M, K) bf16, K a multiple of 64 up to 576; b: (K, N) bf16, N in
    {64, 128}; tile_m must divide M.  CUDA tensors run the kernel, CPU
    tensors the plain version.
    """
    if _check_dot(a, b, tile_m) == "cpu":
        return probe_dot_plain(a, b, tile_m, resident)
    _require_kernel_operands([a, b])
    m, k = a.shape
    n = b.shape[1]
    y = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib = _entry("probe_dot", [vp, vp, vp, ci, ci, ci, ci, ci, vp])
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.jt_probe_dot(a.data_ptr(), b.data_ptr(), y.data_ptr(), m,
                               k, n, tile_m, int(bool(resident)), stream)
    _build.check(lib, err, "probe_dot launch")
    probe_dot.launches += 1
    return y


probe_dot.launches = 0


def probe_dot_bound(a: torch.Tensor, b: torch.Tensor, tile_m: int,
                    resident: bool, ref: torch.Tensor) -> torch.Tensor:
    """How far a correct result may be from ``ref`` (a correct result of
    the same call), element by element: one bf16 ulp of ``ref`` plus the
    largest difference two f32 summation orders can make."""
    rows = a[:tile_m] if resident else a
    slack = _reorder_slack(a.shape[1], rows.float().abs() @ b.float().abs())
    if resident:
        slack = slack.repeat(a.shape[0] // tile_m, 1)
    return bf16_ulp(ref) + slack


# ----------------------------------------------------------------- P2


def _check_patch(x, w1, w2, tile_rows, pair, m):
    if tile_rows < 1 or m < tile_rows:
        raise ValueError(f"need 1 <= tile_rows <= m, got tile_rows "
                         f"{tile_rows}, m {m}")
    if x.dim() != 2 or x.shape[1] != C:
        raise ValueError(f"x must be (rows, {C}), got {tuple(x.shape)}")
    need = tile_rows + HALO + (PW + 1 if pair else 0)  # rows read
    if x.shape[0] < need:
        raise ValueError(f"x must hold at least {need} rows for tile_rows "
                         f"{tile_rows}, got {x.shape[0]}")
    for name, w in (("w1", w1), ("w2", w2)):
        if tuple(w.shape) != (K, C):
            raise ValueError(f"{name} must be ({K}, {C}), got "
                             f"{tuple(w.shape)}")
    if any(t.dtype != torch.bfloat16 for t in (x, w1, w2)):
        raise TypeError("probe_patch_dot takes bfloat16")
    return _on_device([x, w1, w2], "probe_patch_dot")


def _patch(x: torch.Tensor, tile_rows: int) -> torch.Tensor:
    """(tile_rows, 576) f32: tap t = 3 dy + dx of row r is x[dy PW + dx
    + r], lane-concatenated in tap order."""
    xf = x.float()
    return torch.cat([xf[dy * PW + dx:dy * PW + dx + tile_rows]
                      for dy in range(3) for dx in range(3)], dim=1)


def pair_tail_plain(y1: torch.Tensor, x: torch.Tensor,
                    w2: torch.Tensor) -> torch.Tensor:
    """The pair's second half on given first-product rows y1 (rows, 64)
    bf16: ``bf16(concat([y1] * 9) @ w2) + x[HALO + PW + 1 + r]``, the
    product in f32 over the full K = 576, the add in bf16."""
    y2 = (torch.cat([y1.float()] * 9, dim=1) @ w2.float()).to(torch.bfloat16)
    return y2 + x[HALO + PW + 1:HALO + PW + 1 + y1.shape[0]]


def probe_patch_dot_plain(x: torch.Tensor, w1: torch.Tensor,
                          w2: torch.Tensor, tile_rows: int = 2416,
                          pair: bool = False, m: int = M) -> torch.Tensor:
    """The plain PyTorch version: f32 products of the (exactly widened)
    operands, rounded to bfloat16 where the Pallas kernel rounds."""
    _check_patch(x, w1, w2, tile_rows, pair, m)
    y = torch.relu(_patch(x, tile_rows) @ w1.float()).to(torch.bfloat16)
    if pair:
        y = pair_tail_plain(y, x, w2)
    return y.repeat(m // tile_rows, 1)


def probe_patch_dot(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                    tile_rows: int = 2416, pair: bool = False,
                    m: int = M) -> torch.Tensor:
    """(steps tile_rows, 64) bf16 with steps = m // tile_rows (it
    truncates).  Row i tile_rows + r, with t = 3 dy + dx:

        y1 = bf16(relu(sum_t x[dy PW + dx + r] @ w1[64t:64t+64]))

    f32 accumulation; every step reads the same rows.  With ``pair`` the
    row is ``bf16(concat([y1] * 9) @ w2) + x[HALO + PW + 1 + r]``, the
    add in bf16.  x: (rows, 64) bf16 holding the rows read; w1, w2:
    (576, 64) bf16 (w2 is read in pair mode only).  CUDA tensors run the
    kernel, CPU tensors the plain version.
    """
    if _check_patch(x, w1, w2, tile_rows, pair, m) == "cpu":
        return probe_patch_dot_plain(x, w1, w2, tile_rows, pair, m)
    _require_kernel_operands([x, w1, w2])
    steps = m // tile_rows
    y = torch.empty((steps * tile_rows, C), dtype=torch.bfloat16,
                    device=x.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib = _entry("probe_patch_dot", [vp, vp, vp, vp, ci, ci, ci, ci, vp])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.jt_probe_patch_dot(x.data_ptr(), w1.data_ptr(),
                                     w2.data_ptr(), y.data_ptr(), tile_rows,
                                     steps, PW, int(bool(pair)), stream)
    _build.check(lib, err, "probe_patch_dot launch")
    probe_patch_dot.launches += 1
    return y


probe_patch_dot.launches = 0


def probe_patch_dot_bound(x: torch.Tensor, w1: torch.Tensor,
                          tile_rows: int, ref: torch.Tensor,
                          m: int = M) -> torch.Tensor:
    """How far a correct single-product result may be from ``ref`` (a
    correct result of the same call), element by element: one bf16 ulp
    of ``ref`` plus the largest difference two f32 summation orders can
    make."""
    slack = _reorder_slack(K, _patch(x, tile_rows).abs() @ w1.float().abs())
    return (bf16_ulp(ref[:tile_rows]) + slack).repeat(m // tile_rows, 1)


def pair_tail_bound(y1: torch.Tensor, x: torch.Tensor, w2: torch.Tensor,
                    ref: torch.Tensor) -> torch.Tensor:
    """How far a correct pair result computed from the first-product
    rows ``y1`` may be from ``ref`` (``pair_tail_plain`` of the same y1,
    or a correct result that shares that y1), element by element: one
    bf16 ulp of the rounded second product and one of the rounded sum,
    plus the second product's reorder bound.

    The pair is held against its plain version on the rows whose y1
    both round alike: a y1 one ulp apart (within the single product's
    bound) would spread through nine copies of w2, so that difference
    is checked once, on the single product.
    """
    y1f = torch.cat([y1.float()] * 9, dim=1)
    w2f = w2.float()
    slack = _reorder_slack(K, y1f.abs() @ w2f.abs())
    steps = ref.shape[0] // y1.shape[0]
    return (bf16_ulp(y1f @ w2f) + slack).repeat(steps, 1) + bf16_ulp(ref)


def within_bound(got: torch.Tensor, ref: torch.Tensor,
                 bound: torch.Tensor):
    """(every |got - ref| <= bound and got is finite, max |got - ref|)."""
    err = (got.float() - ref.float()).abs()
    return (bool((err <= bound).all()) and bool(torch.isfinite(got).all()),
            float(err.max()))
