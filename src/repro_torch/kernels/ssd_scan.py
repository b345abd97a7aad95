"""Mamba2 SSD chunked scan on the card (CUDA sources: ``csrc/ssd_scan.cu``,
the forward, and ``csrc/ssd_scan_bwd.cu``, its backward).

Replaces the TPU kernel ``repro/kernels/ssd_scan.py::ssd``
(``_ssd_kernel``).  On the serve path every prefill runs it once per
layer, on the mixer's fp32 x, B and C at the prompt's exact length.  The
kernel follows :func:`ssd_plain`'s decomposition as three passes over
chunks of 64 steps: every chunk's own state at once, the short
recurrence over the chunks' states in order, then every chunk's outputs
at once, the products on the tensor cores (3xTF32 for fp32 inputs); its
note says what bounds it.

Where the reference differs, the port follows what the reference model
runs (``repro/models/ssm.py::ssd_chunked``), not the Pallas kernel:

- a ragged tail (S not a multiple of the chunk) is handled by treating
  the steps past S as dt = 0 and x = 0, an identity on the state, where
  the Pallas kernel asserts that the chunk divides S;
- an initial state is an input of the kernel, where the reference's
  ``ops.ssd`` falls back to its sequential oracle whenever one is given;
- the state comes back as (B, H, P, N), the model cache's layout.

Under autograd the wrapper is differentiable on the card: the forward
keeps its pass-2 scratch (the state entering each chunk and each chunk's
total decay, ``B * ceil(S/64) * H * (P*N + 1)`` fp32, 25.2 MB at
mamba2-780m's train shape) for the backward kernel, which recomputes
neither the chunks' states nor the recurrence.  The backward runs
:data:`KERNELS_PER_BWD_CALL` device kernels: the states' gradients in
reverse chunk order, one fused pass over every chunk and slice of heads,
and the ordered sums of the slices' dB and dC.  The reference's Pallas
kernel has no backward (its model trains through ``ssd_chunked`` under
JAX autodiff); the backward kernel replaces none, and its plain version is
autograd through :func:`ssd_plain` (:func:`ssd_backward_plain`), which
the CPU takes.  A ``FakeTensor`` (a dry trace) goes to the kernels' shape
functions, which allocate what the kernels allocate and record their
costs in ``roofline.DRY``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from . import _build, roofline

launches = 0     # calls that launched the kernels since the last reset
                 # (ops.reset_launches); KERNELS_PER_CALL device kernels each
bwd_launches = 0  # backward calls, KERNELS_PER_BWD_CALL device kernels each

MAX_STATE = 256  # N the kernel's shared memory holds (two 64 x N tiles)
MAX_STATE_BWD = 128  # N the backward's chunk pass holds (C and B whole)
MAX_HEAD_BWD = 512   # P whose state-pass partial sums the chunk pass holds
CHUNK = 64       # the kernel's chunk (Q in csrc/ssd_scan.cu)
KERNELS_PER_CALL = 3    # chunk states, the recurrence, chunk outputs
KERNELS_PER_BWD_CALL = 3  # states' gradients, the fused chunk pass, sums
BWD_HEADS = 3    # heads per block of the backward's chunk pass (a slice),
                 # fixed, not sized to the SM count: phase 10's moment gate
                 # sits near its bound (ROADMAP.md queue 3)

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_BWD_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 8
                 + [ctypes.c_void_p])


def ssd_plain(
    x: torch.Tensor,               # (B, S, H, P)
    dt: torch.Tensor,              # (B, S, H)
    A: torch.Tensor,               # (H,)
    Bm: torch.Tensor,              # (B, S, G, N)
    C: torch.Tensor,               # (B, S, G, N)
    *,
    chunk: int = 256,
    init_state: Optional[torch.Tensor] = None,   # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked dual form of ``repro.models.ssm.ssd_chunked`` in plain
    PyTorch (fp32 math): returns y (B, S, H, P) in x's dtype and the final
    state (B, H, P, N) fp32.

    The decay matrix takes the exponent only where j <= i; above the
    diagonal the exponent is replaced by -inf before ``exp``, so no inf
    is ever formed."""
    B, S, H, P = x.shape
    _, _, G, N = Bm.shape
    rep = H // G
    chunk = max(1, min(chunk, S))
    s_valid = S
    S_pad = -(-S // chunk) * chunk
    if S_pad != S:               # dt = 0 steps: identity on the state
        pad = S_pad - S
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, 0, 0, pad))
        S = S_pad
    nc = S // chunk

    xf = x.float().reshape(B, nc, chunk, H, P)
    dtf = dt.float().reshape(B, nc, chunk, H)
    Bf = Bm.float().repeat_interleave(rep, 2).reshape(B, nc, chunk, H, N)
    Cf = C.float().repeat_interleave(rep, 2).reshape(B, nc, chunk, H, N)

    a_cum = torch.cumsum(dtf * A.float(), dim=2)                # (B,nc,Q,H)
    a_tot = a_cum[:, :, -1, :]                                  # (B,nc,H)

    diff = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]    # (B,nc,Q,K,H)
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                   device=x.device))
    L = torch.exp(diff.masked_fill(~causal[None, None, :, :, None],
                                   float("-inf")))
    scores = torch.einsum("bcqhn,bckhn->bcqkh", Cf, Bf) * L
    xdt = xf * dtf[..., None]
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", scores, xdt)

    b_decay = Bf * torch.exp(a_tot[:, :, None, :] - a_cum)[..., None]
    states = torch.einsum("bckhn,bckhp->bchpn", b_decay, xdt)   # (B,nc,H,P,N)

    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = torch.exp(a_tot[:, c])[..., None, None] * h + states[:, c]
    h_in = torch.stack(h_in, 1)                                 # (B,nc,H,P,N)

    y_off = torch.einsum("bcqhn,bchpn->bcqhp",
                         Cf * torch.exp(a_cum)[..., None], h_in)
    y = (y_diag + y_off).reshape(B, S, H, P)[:, :s_valid]
    return y.to(x.dtype), h


def _check(x, dt, A, Bm, C, init_state) -> None:
    """What the kernels take: contiguous x, B and C all bf16 or all fp32,
    fp32 dt, A and ``init_state``, one CUDA device (or fake tensors),
    N <= :data:`MAX_STATE`."""
    tensors = [x, dt, A, Bm, C] + ([init_state] if init_state is not None
                                   else [])
    if not isinstance(x, FakeTensor) and (
            x.device.type != "cuda"
            or any(t.device != x.device for t in tensors)):
        raise ValueError("ssd: the kernel needs every tensor on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if x.dtype not in (torch.bfloat16, torch.float32) \
            or Bm.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd kernel takes x, B and C all bf16 or all fp32, "
                        f"got {x.dtype}, {Bm.dtype}, {C.dtype}")
    if any(t.dtype != torch.float32 for t in tensors[1:3] + tensors[5:]):
        raise TypeError("ssd kernel takes fp32 dt, A and init_state")
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"ssd: x {tuple(x.shape)}, B {tuple(Bm.shape)}")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,) \
            or tuple(Bm.shape) != (Bsz, S, G, N) or C.shape != Bm.shape \
            or G == 0 or H % G \
            or (init_state is not None
                and tuple(init_state.shape) != (Bsz, H, P, N)):
        raise ValueError(
            f"ssd: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(Bm.shape)}, C {tuple(C.shape)}, "
            f"init_state "
            f"{None if init_state is None else tuple(init_state.shape)} "
            "do not match")
    if N > MAX_STATE:
        raise ValueError(f"ssd kernel takes a state of at most {MAX_STATE}, "
                         f"got N = {N}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd kernel takes contiguous tensors")


def _forward(x, dt, A, Bm, C, init_state):
    """(y, final state, scratch): the forward kernels' outputs and their
    pass-2 scratch, the states entering each chunk and the chunks' total
    decays (None where nothing was launched)."""
    global launches
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty_like(x)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    if Bsz * H * P * N == 0:
        return y, state.zero_(), None
    if S == 0:
        return y, (state.zero_() if init_state is None
                   else state.copy_(init_state)), None
    nc = -(-S // CHUNK)
    scratch = torch.empty(Bsz * nc * H * (P * N + 1), dtype=torch.float32,
                          device=x.device)
    if isinstance(x, FakeTensor):          # a dry trace: no launch
        roofline.DRY.record("ssd", roofline.ssd_cost(
            Bsz, S, H, P, G, N, x.element_size(), init_state is not None,
            CHUNK))
        return y, state, scratch
    per16 = 16 // x.element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, Bm, C))
    vec_x = int(aligned and P % per16 == 0)
    vec_bc = int(aligned and N % per16 == 0)
    fn = _build.function("dmath_ssd_scan", _ARGTYPES)
    rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            C.data_ptr(),
            None if init_state is None else init_state.data_ptr(),
            y.data_ptr(), state.data_ptr(), scratch.data_ptr(), Bsz, S, H, G,
            P, N, int(x.dtype == torch.bfloat16), vec_x, vec_bc,
            int(N % 4 == 0),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "ssd")
    launches += 1
    return y, state, scratch


def _bwd_slices(H: int, G: int) -> int:
    """Slices of each group's heads in the backward's chunk pass (``csrc/
    ssd_scan_bwd.cu``), :data:`BWD_HEADS` heads each, the last taking what
    is left.  A slice's dB and dC are summed over its heads in head order,
    then the slices in order, so the sums follow the heads' indices alone:
    a call on the first half of the heads (a mesh rank's) gives bitwise
    the whole call's partial sum of that half.  At mamba2-780m's 2 x 512
    and 48 heads that is 256 blocks of one an SM, two waves of an H100's
    132 SMs; at a (2, 2) mesh rank's 24 heads, one wave."""
    return -(-(H // G) // BWD_HEADS)


def _bwd_work_floats(Bsz: int, S: int, H: int, G: int, P: int,
                     N: int) -> int:
    """The backward's fp32 scratch (``csrc/ssd_scan_bwd.cu``): per chunk
    and head the states' gradients dS (P*N), the state pass's partial
    sums of the total decays' gradients (8 per 64 of P) and dA's partial
    sum; per slice of heads its sums of dB and dC (64 N a chunk and
    group each)."""
    nc = -(-S // CHUNK)
    return Bsz * nc * H * (P * N + 8 * -(-P // 64) + 1) \
        + 2 * _bwd_slices(H, G) * Bsz * nc * CHUNK * G * N


def ssd_backward(x, dt, A, Bm, C, dy, d_state, scratch, *,
                 init_state: Optional[torch.Tensor] = None):
    """(dx, ddt, dA, dB, dC, d_init) of the forward kernel's call on these
    inputs, for the cotangents ``dy`` (x's shape) and ``d_state`` ((B, H,
    P, N) or None, a zero), from the forward's ``scratch``
    (:func:`_forward`), by the backward kernel: dx, dB and dC in their
    inputs' types, ddt, dA and d_init fp32 (d_init None without an
    initial state).  CUDA tensors only: the CPU differentiates
    :func:`ssd_plain`."""
    global bwd_launches
    _check(x, dt, A, Bm, C, init_state)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if N > MAX_STATE_BWD or P > MAX_HEAD_BWD:
        raise ValueError(f"ssd backward kernel takes a state of at most "
                         f"{MAX_STATE_BWD} and heads of at most "
                         f"{MAX_HEAD_BWD}, got N = {N}, P = {P}")
    dy = (torch.zeros_like(x) if dy is None
          else dy.to(x.dtype).contiguous())
    if d_state is not None:
        d_state = d_state.float().contiguous()
        if tuple(d_state.shape) != (Bsz, H, P, N):
            raise ValueError(f"ssd backward: d_state {tuple(d_state.shape)}")
    dx, dB, dC = (torch.empty_like(t) for t in (x, Bm, C))
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    d_init = None if init_state is None else torch.empty_like(init_state)
    if scratch is None:       # nothing was launched: an empty call
        for t in (dx, dB, dC, ddt, dA):
            t.zero_()
        if d_init is not None:
            d_init.copy_(d_state) if d_state is not None else d_init.zero_()
        return dx, ddt, dA, dB, dC, d_init
    work = torch.empty(_bwd_work_floats(Bsz, S, H, G, P, N),
                       dtype=torch.float32, device=x.device)
    if isinstance(x, FakeTensor):          # a dry trace: no launch
        roofline.DRY.record("ssd_backward", roofline.ssd_backward_cost(
            Bsz, S, H, P, G, N, x.element_size(), init_state is not None,
            d_state is not None, CHUNK))
        return dx, ddt, dA, dB, dC, d_init
    fn = _build.function("dmath_ssd_scan_bwd", _BWD_ARGTYPES)
    rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            C.data_ptr(), dy.data_ptr(),
            None if d_state is None else d_state.data_ptr(),
            scratch.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
            dB.data_ptr(), dC.data_ptr(),
            None if d_init is None else d_init.data_ptr(), work.data_ptr(),
            Bsz, S, H, G, P, N, BWD_HEADS, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "ssd_backward")
    bwd_launches += 1
    return dx, ddt, dA, dB, dC, d_init


class _SSD(torch.autograd.Function):
    """The forward kernels, keeping their pass-2 scratch; the backward
    kernels."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, C, init_state):
        y, state, scratch = _forward(x, dt, A, Bm, C, init_state)
        ctx.save_for_backward(x, dt, A, Bm, C, init_state, scratch)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, d_state):
        x, dt, A, Bm, C, init_state, scratch = ctx.saved_tensors
        return ssd_backward(x, dt, A, Bm, C, dy, d_state, scratch,
                            init_state=init_state)


def ssd(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    C: torch.Tensor,
    *,
    chunk: int = 256,
    init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, H, P), final state (B, H, P, N) fp32).

    CPU tensors take the plain version (:func:`ssd_plain`, chunked by
    ``chunk``), which autograd differentiates.  CUDA tensors launch the
    kernels, which cut chunks of their own length, :data:`CHUNK`
    (``chunk`` is accepted for the reference's signature; the result does
    not depend on it), and take contiguous x, B and C all bf16 or all
    fp32, fp32 dt, A and ``init_state``; anything else raises.  With
    autograd recording, the backward kernel gives every input's gradient
    (N <= :data:`MAX_STATE_BWD`, P <= :data:`MAX_HEAD_BWD`)."""
    tensors = [x, dt, A, Bm, C] + ([init_state] if init_state is not None
                                   else [])
    if all(t.device.type == "cpu" for t in tensors) \
            and not isinstance(x, FakeTensor):
        return ssd_plain(x, dt, A, Bm, C, chunk=chunk, init_state=init_state)
    _check(x, dt, A, Bm, C, init_state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _SSD.apply(x, dt, A, Bm, C, init_state)
    return _forward(x, dt, A, Bm, C, init_state)[:2]


def ssd_backward_plain(x, dt, A, Bm, C, dy, d_state=None, *,
                       init_state: Optional[torch.Tensor] = None):
    """The backward kernel's plain version: autograd through
    :func:`ssd_plain` on copies of the inputs, (dx, ddt, dA, dB, dC,
    d_init) in the inputs' types (d_init None without an initial
    state).  For tests and ``chip_smoke.py``; the card's path never runs
    it."""
    ins = [t.detach().clone().requires_grad_(True)
           for t in (x, dt, A, Bm, C)
           + ((init_state,) if init_state is not None else ())]
    with torch.enable_grad():
        y, state = ssd_plain(*ins[:5], init_state=(
            ins[5] if init_state is not None else None))
        outs, cots = [y], [dy.to(y.dtype)]
        if d_state is not None:
            outs.append(state)
            cots.append(d_state.float())
        grads = torch.autograd.grad(outs, ins, cots, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(ins, grads)]
    return (*grads[:5], grads[5] if init_state is not None else None)
