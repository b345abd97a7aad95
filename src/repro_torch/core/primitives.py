"""Distributed primitives named by the paper, ported from the reference's
``core/primitives.py``.

- :func:`add_row_col_sum_matrix` — the paper's §2.3 example subroutine:
  ``M + alpha * rowsum(M) + beta * colsum(M)`` broadcast back onto the
  matrix, M row-sharded.  The deterministic mode reduces the column sums
  in fp32 (in rank order over the axis); the fast mode reduces bf16
  partial sums (registered in ``core.rng.NONDETERMINISTIC_OPS``).

- :func:`conv2d_halo` — 2-D convolution with the batch data-parallel and
  the HEIGHT spatially sharded over the model axis: each rank exchanges
  its kernel-radius boundary rows with both neighbours (the halo; zeros
  past the ends, no wrap), then convolves its padded block alone.  The
  local conv is ``F.conv2d`` in fp32, as the reference computes it with
  XLA's conv (no Pallas kernel), under cuDNN's flags with TF32 off: cuDNN
  allows TF32 by default, which would not be an fp32 conv.

Both take this rank's block and return its block of the result.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import distributed as D


def add_row_col_sum_matrix(m: torch.Tensor, alpha: float = 1.0,
                           beta: float = 1.0, *, mesh, axis: str = "model",
                           deterministic: bool = True) -> torch.Tensor:
    """M[i,j] + alpha * rowsum_i + beta * colsum_j for this rank's rows of
    a row-sharded M (R, C).

    The row sums are the rank's own; the column sums need the cross-rank
    reduction whose ORDER is the §2.3 determinism question:
    ``deterministic=True`` reduces fp32 partial sums, ``False`` bf16 ones
    (half the wire, rounded in bf16)."""
    mf = m.float()
    rowsum = mf.sum(dim=1, keepdim=True)
    local_col = m.to(torch.float32 if deterministic else torch.bfloat16
                     ).sum(dim=0, keepdim=True)
    colsum = D.psum(local_col, mesh, axis).float()
    return (mf + alpha * rowsum + beta * colsum).to(m.dtype)


def conv2d_halo(x: torch.Tensor, w: torch.Tensor, *, mesh,
                axis: str = "model",
                batch_axis: Optional[str] = "data") -> torch.Tensor:
    """SAME-padded, stride-1 conv of this rank's block ``x`` (B_loc,
    H_loc, W, Cin), NHWC, the height sharded over ``axis`` (and the batch
    over ``batch_axis``, which needs nothing here), with the replicated
    weight ``w`` (kh, kw, Cin, Cout), HWIO.  Wire bytes are the halo's:
    kh // 2 rows to each neighbour."""
    kh, kw = w.shape[0], w.shape[1]
    r = kh // 2
    n = mesh.shape[axis]
    if r and n > 1:
        idx = mesh.coords[axis]
        top = torch.zeros_like(x[:, :r])
        bot = torch.zeros_like(x[:, :r])
        sends, recvs = {}, {}
        if idx > 0:                    # my first rows go up, its last come
            sends[idx - 1] = x[:, :r].contiguous()
            recvs[idx - 1] = top
        if idx < n - 1:
            sends[idx + 1] = x[:, -r:].contiguous()
            recvs[idx + 1] = bot
        D.exchange(sends, recvs, mesh, axis)
        ext = torch.cat([top, x, bot], dim=1)
    else:
        ext = F.pad(x, (0, 0, 0, 0, r, r))
    return local_conv(ext, w).to(x.dtype)


def local_conv(ext: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The fp32 conv of a halo-padded block (NHWC, H already padded): W
    padded by kw // 2, no TF32 on the card."""
    xs = ext.float().permute(0, 3, 1, 2)              # NCHW
    ws = w.float().permute(3, 2, 0, 1)                # (Cout, Cin, kh, kw)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        out = F.conv2d(xs, ws, padding=(0, w.shape[1] // 2))
    return out.permute(0, 2, 3, 1)
