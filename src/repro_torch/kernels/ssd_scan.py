"""Mamba2 SSD chunked scan on the card (CUDA source: ``csrc/ssd_scan.cu``).

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
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

launches = 0     # calls that launched the kernels since the last reset
                 # (ops.reset_launches); a call runs three device kernels

MAX_STATE = 256  # N the kernel's shared memory holds (two 64 x N tiles)
CHUNK = 64       # the kernel's chunk (Q in csrc/ssd_scan.cu)
KERNELS_PER_CALL = 3    # chunk states, the recurrence, chunk outputs

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


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
    ``chunk``).  CUDA tensors launch the kernels, which cut chunks of
    their own length, :data:`CHUNK` (``chunk`` is accepted for the
    reference's signature; the result does not depend on it), and take
    contiguous x, B and C all bf16 or all fp32, fp32 dt, A and
    ``init_state``; anything else raises."""
    global launches
    tensors = [x, dt, A, Bm, C] + ([init_state] if init_state is not None
                                   else [])
    if all(t.device.type == "cpu" for t in tensors):
        return ssd_plain(x, dt, A, Bm, C, chunk=chunk, init_state=init_state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "ssd: the kernel has no backward; "
            "only the dense family's train path is ported")
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
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
    y = torch.empty_like(x)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    if Bsz * H * P * N == 0:
        return y, state.zero_()
    if S == 0:
        return y, (state.zero_() if init_state is None
                   else state.copy_(init_state))
    nc = -(-S // CHUNK)
    scratch = torch.empty(Bsz * nc * H * (P * N + 1), dtype=torch.float32,
                          device=x.device)
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
    return y, state
