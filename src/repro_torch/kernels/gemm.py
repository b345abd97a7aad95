"""Mixed-precision GEMM on the card: C = A @ B, fp32 accumulator, one
downcast (CUDA source: ``csrc/gemm.cu``).

Replaces the TPU kernel ``repro/kernels/gemm.py::matmul``
(``_matmul_kernel``), dMath's core kernel.  On the serve path every
projection, MLP and unembed product runs here, at M = batch slots
(decode) or M = one prefill chunk; in training, every forward product
and both backward products.  At decode each product does a few
operations per weight byte, far below the H100's ~295 bf16 FLOP/byte
ridge, so B's bytes over 3.35 TB/s bound it (the unembed's 272 MB:
~81 us); at train shapes (M = 1,024) the large products are bound by the
tensor cores.  The kernel (see the source's header) runs Cᵀ = Bᵀ·Aᵀ on
Hopper's wgmma with the weights on the 64-row side and the tokens on the
narrow side, fed by TMA through a ring of shared-memory stages, and sums
K in fixed groups of :data:`KG` added in order, so two runs give the same
bits and row i of C depends on A[i], B, K and N only.

:func:`plan` is the whole policy, a plain function of the shapes, the
dtype and the layout: ``skinny`` (M <= 64: one consumer warpgroup, the
token tile rounded up to 8, 16, 32 or 64), ``wide`` (two consumer
warpgroups, 128 columns by 128 or 64 tokens; also every call whose A is
stored transposed) or ``fp32`` (CUDA-core FMAs, 64 x 64 tiles), the K
group depth (a function of K), and a split of K over blocks, one group
each, when the tiles alone leave the card's 132 SMs short.  A split
writes each group's sum to fp32 scratch (allocated here with
``torch.empty``) and a second launch adds them in group order: the same
adds the unsplit kernel does in registers.  :func:`uses_tma` picks the
TMA producer when the stored rows are whole 16-byte multiples, else the
kernel's element-load producer (the same consumer, the same bits).

Training differentiates through :func:`matmul` (a
``torch.autograd.Function``): the backward runs dA = dC·Bᵀ and dB = Aᵀ·dC
on the same kernel with Bᵀ and Aᵀ passed as transposed views (the kernel
reads either layout), so no transposed copy is made.  The cotangent dC
arrives in fp32 (the forward's accumulator type) and is rounded once to
the operands' type, because the kernel takes operands of one type; JAX's
transpose multiplies the fp32 cotangent and rounds the product instead.
The plain version rounds dC the same way, so a CPU test sees exactly the
card's deviation.

fp32 operands (and a bf16 operand beside an fp32 one, promoted as
``torch.promote_types`` does) take the fp32 kernel.

Batched mode (the moe family's expert banks, ``ecd,edf->ecf``):
``matmul(a (E, M, K), b (E, K, N))`` is one launch over all E products.
The persistent kernel's tile index runs over the experts too, the tensor
maps are 3-D, and every expert's tiles run :func:`plan` of (M, K, N), the
2-D product's tiles and K groups, so slice e is bitwise the 2-D kernel on
(a[e], b[e]) (row invariance and run-to-run bits carry over).  Its
backward runs dA = dC·Bᵀ and dB = Aᵀ·dC batched on the same kernel
through transposed views, as the 2-D backward does.  The plain version
is the 2-D plain version per expert.  ``launches`` counts one batched
call as one launch.

:func:`matmul_dequant` (the same source) replaces the TPU kernel
``repro/kernels/gemm.py::matmul_dequant``: C = (A @ B_q) · scale[N] with
int8 weights widened inside the kernel and the per-column scale applied
to the finished fp32 sum, so the dequantized B never exists in device
memory.  It runs the same kernels under the same :func:`plan` as
:func:`matmul` (bf16 A: the int8 tile TMA-loaded and widened in shared
memory ahead of wgmma; fp32 A: widened on the CUDA-core kernel's load),
so its result is bitwise ``matmul(a, b_q.to(a.dtype), torch.float32) *
b_scale`` cast once, and inherits row invariance and run-to-run bits.  It
is reached through ``ops.matmul_dequant`` only, as in the reference (no
model path calls it); at qwen2-0.5b's decode shapes it is bound by the
int8 bytes of B, half the bf16 GEMM's.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

from . import _build, ref, roofline

launches = 0     # matmul products since the last reset (ops.reset_launches)
batched_launches = 0     # of those, batched (an expert bank in one launch)
dequant_launches = 0     # matmul_dequant launches

KG = 256          # the K group depth's unit: summed from zero, added in order
MAX_GROUPS = 32   # deeper K takes deeper groups (a multiple of KG)
SMS = 132         # the H100's streaming multiprocessors
SKINNY_TILES = (8, 16, 32, 64)
_KINDS = (torch.bfloat16, torch.float32)
_entry = None     # the C entries, looked up on first launch
_batched_entry = None
_dequant_entry = None

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]

# dmath_gemm_batched: dmath_gemm's with the batch after the scratch
_BATCHED_ARGTYPES = _ARGTYPES[:7] + [ctypes.c_int] + _ARGTYPES[7:]

_DEQUANT_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_void_p]


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one product runs: ``regime`` (skinny: one consumer warpgroup,
    a tile of 64 weight columns; wide: two, 128 columns; fp32: CUDA-core
    FMAs, 64 x 64), the tile (``tile_m`` tokens x ``tile_n`` columns),
    the K group depth ``kg`` and the count of ``groups``, and ``split``:
    1, or one block per group (each group's sum goes to scratch and a
    second pass adds them in order)."""

    regime: str
    tile_m: int
    tile_n: int
    kg: int
    groups: int
    split: int


def group_depth(K: int) -> int:
    """The K group depth: KG, or the least multiple of KG that cuts K into
    at most MAX_GROUPS groups.  A function of K alone."""
    units = -(-K // KG)
    return KG * -(-units // MAX_GROUPS)


@functools.lru_cache(maxsize=4096)
def plan(M: int, K: int, N: int, *, f32: bool = False,
         a_transposed: bool = False) -> Plan:
    """The kernel's plan for an (M, K) @ (K, N) product: a plain function
    of the shapes, the operand dtype and A's layout.  The K groups depend
    on K alone and every tile and split adds the same group sums in the
    same order, so the plan never changes the bits.

    - fp32: 64 x 64 tiles.
    - skinny (M <= 64, A row-major): 64 columns by M rounded up to 8, 16,
      32 or 64 tokens.
    - wide (otherwise): 128 columns by 128 tokens where that gives the
      card's SMs a tile each, else by 64.
    A split (one block per group) is taken when the tiles leave SMs idle:
    fewer tiles than SMs for the skinny and fp32 kernels, fewer than half
    for the wide one (whose blocks are heavy, and whose scratch would be
    large)."""
    kg = group_depth(K)
    groups = -(-K // kg)
    tiles_of = lambda tm, tn: -(-M // tm) * -(-N // tn)  # noqa: E731
    if f32:
        regime, tm, tn, idle = "fp32", 64, 64, SMS
    elif M <= SKINNY_TILES[-1] and not a_transposed:
        regime, tn, idle = "skinny", 64, SMS
        tm = next(t for t in SKINNY_TILES if t >= M)
    else:
        regime, tn, idle = "wide", 128, SMS // 2
        tm = 128 if tiles_of(128, 128) >= SMS else 64
    tiles = tiles_of(tm, tn)
    split = groups if tiles < idle and groups > 1 else 1
    return Plan(regime, tm, tn, kg, groups, split)


def plan_of(a: torch.Tensor, b: torch.Tensor, a_transposed: bool = False
            ) -> Plan:
    """The plan of the launch for ``a`` (M, K) @ ``b`` (K, N), or of each
    expert's product for ``a`` (E, M, K) @ ``b`` (E, K, N): the fp32
    kernel when ``a`` is fp32.  The type of ``b`` plays no part, so an
    int8 ``b`` (:func:`matmul_dequant`) takes the plan of ``b`` widened to
    ``a``'s type."""
    M, K = a.shape[-2:]
    return plan(M, K, b.shape[-1], f32=a.dtype == torch.float32,
                a_transposed=a_transposed)


def uses_tma(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True when both operands' stored rows are whole 16-byte multiples
    and their bases 16-byte aligned (TMA's rule); else the kernel's
    element-load producer runs.  A batched operand's slices are packed,
    so its slice stride is a multiple of its row stride."""
    return ((a.data_ptr() | b.data_ptr()) % 16 == 0
            and a.element_size() * max(a.stride()[-2:]) % 16 == 0
            and b.element_size() * max(b.stride()[-2:]) % 16 == 0)


def _layout(t: torch.Tensor, what: str) -> int:
    """0: row-major contiguous; 1: the transpose of a contiguous array
    (batched: of each packed slice)."""
    if t.is_contiguous():
        return 0
    if t.mT.is_contiguous():
        return 1
    raise ValueError(f"matmul kernel takes {what} row-major or as the "
                     "transpose of a contiguous array, got strides "
                     f"{t.stride()}")


class _MatMul(torch.autograd.Function):
    """C = A @ B with both backward products on the same kernel."""

    @staticmethod
    def forward(ctx, a, b, out_dtype):
        ctx.save_for_backward(a, b)
        return _product(a, b, out_dtype)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        g = dc.to(torch.promote_types(a.dtype, b.dtype)).contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _product(g, b.mT, a.dtype)
        if ctx.needs_input_grad[1]:
            db = _product(a.mT, g, b.dtype)
        return da, db, None


def matmul(a: torch.Tensor, b: torch.Tensor,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) in ``out_dtype`` (default ``a.dtype``);
    batched, (E, M, K) @ (E, K, N) -> (E, M, N), one launch.

    CPU tensors take the plain version (:func:`ref.matmul`); CUDA tensors
    launch the kernel, which takes bf16 or fp32 operands (a bf16 one
    beside an fp32 one is widened first), each row-major or the transpose
    of a contiguous array, and writes fp32 or bf16; it raises on anything
    else.  Differentiable: with autograd recording, the backward products
    run the same way."""
    out_dtype = out_dtype or a.dtype
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _MatMul.apply(a, b, out_dtype)
    return _product(a, b, out_dtype)


def _product(a: torch.Tensor, b: torch.Tensor,
             out_dtype: torch.dtype) -> torch.Tensor:
    # The decode step is host-bound, so this path is kept lean: cheap
    # tensor attributes (``is_cuda``, ``get_device``), the cached plan and
    # C entry, and the raw stream handle (``torch.cuda.current_stream``
    # builds a Stream object per call).
    global launches, batched_launches, _entry, _batched_entry
    fake = isinstance(a, FakeTensor)       # a dry trace: no launch
    if not (a.is_cuda and b.is_cuda or fake):
        if a.device.type == "cpu" and b.device.type == "cpu":
            return ref.matmul(a, b, out_dtype)
        raise ValueError(f"matmul: operands on {a.device} and {b.device}; "
                         "the kernel needs both on one CUDA device")
    if a.get_device() != b.get_device():
        raise ValueError(f"matmul: operands on {a.device} and {b.device}; "
                         "the kernel needs both on one CUDA device")
    if a.dtype not in _KINDS or b.dtype not in _KINDS:
        raise TypeError(f"matmul kernel takes bf16 or fp32 operands, got "
                        f"{a.dtype} @ {b.dtype}")
    if out_dtype not in _KINDS:
        raise TypeError(f"matmul kernel writes fp32 or bf16, not {out_dtype}")
    nd = a.dim()
    if nd != b.dim() or nd not in (2, 3) or a.shape[-1] != b.shape[-2] \
            or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} do not chain")
    if a.dtype != b.dtype:                 # mixed: widen the bf16 operand
        a, b = a.float(), b.float()
    a_t, b_t = _layout(a, "A"), _layout(b, "B")
    M, K = a.shape[-2:]
    N = b.shape[-1]
    batch = a.shape[0] if nd == 3 else 1
    out = torch.empty(a.shape[:-1] + (N,), dtype=out_dtype, device=a.device)
    if M == 0 or N == 0 or batch == 0:
        return out
    if K == 0:
        return out.zero_()
    pl = plan_of(a, b, bool(a_t))
    if fake:
        return _dry(a, b, out, pl)
    scratch = (torch.empty((batch, pl.groups, M, N), dtype=torch.float32,
                           device=a.device).data_ptr()
               if pl.split > 1 else None)
    plan_args = (M, N, K, int(a.dtype == torch.float32), pl.kg, pl.tile_m,
                 1 if pl.tile_n == 64 else 2, pl.split, int(uses_tma(a, b)),
                 torch._C._cuda_getCurrentRawStream(a.get_device()))
    head = (a.data_ptr(), a_t, b.data_ptr(), b_t, out.data_ptr(),
            int(out_dtype == torch.float32), scratch)
    if nd == 2:
        if _entry is None:
            _entry = _build.function("dmath_gemm", _ARGTYPES)
        rc = _entry(*head, *plan_args)
    else:
        if _batched_entry is None:
            _batched_entry = _build.function("dmath_gemm_batched",
                                             _BATCHED_ARGTYPES)
        rc = _batched_entry(*head, batch, *plan_args)
    if rc:
        _build.check(rc, "matmul")
    launches += 1
    if nd == 3:
        batched_launches += 1
    return out


def _dry(a, b, out, pl: Plan) -> torch.Tensor:
    """The launch's shape function, for fake tensors: the split's fp32
    scratch, as the kernel's wrapper allocates it (``out`` is allocated
    already), and the product's cost in ``roofline.DRY``."""
    batch = a.shape[0] if a.dim() == 3 else 1
    M, K = a.shape[-2:]
    if pl.split > 1:
        torch.empty((batch, pl.groups, M, out.shape[-1]),
                    dtype=torch.float32, device=a.device)
    roofline.DRY.record("matmul", roofline.matmul_cost(
        M, K, b.shape[-1], a.element_size(), b.element_size(),
        out.element_size(), batch=batch))
    return out


def matmul_dequant(a: torch.Tensor, b_q: torch.Tensor, b_scale: torch.Tensor,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(M, K) @ (K, N) int8, times ``b_scale`` (N,) per column -> (M, N) in
    ``out_dtype`` (default ``a.dtype``).

    CPU tensors take the plain version (:func:`ref.matmul_dequant`); CUDA
    tensors launch the kernel, which takes contiguous bf16 or fp32 ``a``,
    int8 ``b_q`` and fp32 ``b_scale`` on one device and writes fp32 or
    bf16, and raise on anything else.  Not differentiable (the reference
    has no backward).  The result is bitwise that of :func:`matmul` on
    ``b_q.to(a.dtype)`` in fp32, times ``b_scale``, cast once."""
    global dequant_launches, _dequant_entry
    out_dtype = out_dtype or a.dtype
    devs = {t.device for t in (a, b_q, b_scale)}
    if devs == {torch.device("cpu")}:
        return ref.matmul_dequant(a, b_q, b_scale, out_dtype)
    if len(devs) != 1 or a.device.type != "cuda":
        raise ValueError(f"matmul_dequant: operands on {sorted(map(str, devs))}"
                         "; the kernel needs all three on one CUDA device")
    if a.dtype not in (torch.bfloat16, torch.float32) \
            or b_q.dtype != torch.int8 or b_scale.dtype != torch.float32:
        raise TypeError(f"matmul_dequant kernel takes bf16/fp32 a, int8 b_q "
                        f"and fp32 b_scale, got {a.dtype}, {b_q.dtype}, "
                        f"{b_scale.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"matmul_dequant kernel writes fp32 or bf16, not "
                        f"{out_dtype}")
    if a.dim() != 2 or b_q.dim() != 2 or a.shape[1] != b_q.shape[0] \
            or tuple(b_scale.shape) != (b_q.shape[1],):
        raise ValueError(f"matmul_dequant: shapes {tuple(a.shape)} @ "
                         f"{tuple(b_q.shape)} * {tuple(b_scale.shape)} do "
                         "not chain")
    if not (a.is_contiguous() and b_q.is_contiguous()
            and b_scale.is_contiguous()):
        raise ValueError("matmul_dequant kernel takes contiguous operands")
    M, K = a.shape
    N = b_q.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    pl = plan_of(a, b_q)
    scratch = (torch.empty((pl.groups, M, N), dtype=torch.float32,
                           device=a.device).data_ptr()
               if pl.split > 1 else None)
    if _dequant_entry is None:
        _dequant_entry = _build.function("dmath_gemm_dequant",
                                         _DEQUANT_ARGTYPES)
    rc = _dequant_entry(a.data_ptr(), b_q.data_ptr(), b_scale.data_ptr(),
                        out.data_ptr(), int(out_dtype == torch.float32),
                        scratch, M, N, K, int(a.dtype == torch.float32),
                        pl.kg, pl.tile_m, 1 if pl.tile_n == 64 else 2,
                        pl.split, int(uses_tma(a, b_q)),
                        torch._C._cuda_getCurrentRawStream(a.get_device()))
    if rc:
        _build.check(rc, "matmul_dequant")
    dequant_launches += 1
    return out
