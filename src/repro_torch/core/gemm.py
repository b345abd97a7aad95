"""Layout-dispatched distributed GEMM (paper §3.2), ported from the
reference's ``core/gemm.py``.

dMath's defining property: GEMM is *correct for any operand layouts* —
the library inspects the distributions, chooses an algorithm, and moves
what it must to make the operands compatible.  Every function is SPMD:
each rank passes its blocks of A and B and gets its block of C.

  name         A layout      B layout      C layout      comm
  ----------   -----------   -----------   -----------   -------------------
  local        compatible    compatible    inherited     none
  row_par      L[ax,-]       L[-,-]        L[ax,-]       none
  col_par      L[-,-]        L[-,ax]       L[-,ax]       none
  inner_psum   L[-,ax]       L[ax,-]       L[-,-]        all-reduce(C)
  inner_rs     L[-,ax]       L[ax,-]       L[ax,-]       reduce-scatter(C)
  summa2d      L[r,c]        L[r,c]        L[r,c]        all-gather(A, c) +
                                                         all-gather(B, r)
  auto         anything      anything      requested     minimal relayouts +
                                                         one of the above

Each rank's product is one :func:`repro_torch.core.precision.matmul`, so
on the card it is one launch of the GEMM kernel (bf16 on wgmma, fp32 on
the CUDA cores).  :func:`plan_gemm` costs each candidate with the
reference's analytic byte model and picks as it does; plans are memoized
in the op cache under (shapes, layouts, mesh) — §3.3's cached metadata
identifiers.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from . import distributed as D
from . import precision
from .layout import Layout
from .opcache import GLOBAL_CACHE
from .redistribute import collective_bytes_estimate, relayout_explicit


def _local_mm(a, b, policy):
    return precision.matmul(a, b, policy=policy)


def gemm_row_parallel(a, b, mesh, axis: str = "model",
                      policy: precision.Policy = precision.MIXED):
    """A row-sharded, B replicated -> C row-sharded.  No communication."""
    return _local_mm(a, b, policy)


def gemm_col_parallel(a, b, mesh, axis: str = "model",
                      policy: precision.Policy = precision.MIXED):
    """A replicated, B col-sharded -> C col-sharded.  No communication."""
    return _local_mm(a, b, policy)


def gemm_inner_psum(a, b, mesh, axis: str = "model",
                    policy: precision.Policy = precision.MIXED):
    """A K-sharded, B K-sharded -> C replicated via all-reduce.

    The partial products accumulate in ``policy.accum_dtype`` and the
    all-reduce runs in ``policy.reduce_dtype`` (fp32 C for bf16
    operands)."""
    part = _local_mm(a, b, policy).to(policy.reduce_dtype)
    return D.psum(part, mesh, axis)


def gemm_inner_rs(a, b, mesh, axis: str = "model",
                  policy: precision.Policy = precision.MIXED):
    """A K-sharded, B K-sharded -> C row-sharded via reduce-scatter: 1/n
    of the all-reduce's bytes."""
    part = _local_mm(a, b, policy).to(policy.reduce_dtype)
    return D.psum_scatter(part, mesh, axis, 0)


def gemm_summa2d(a, b, mesh, axes: Tuple[str, str] = ("data", "model"),
                 policy: precision.Policy = precision.MIXED):
    """2-D blocked SUMMA: A, B, C all blocked over (rows=axes[0],
    cols=axes[1]).  Each (r, c) block gathers A's row panel along the
    column axis and B's column panel along the row axis, then one local
    GEMM (the wire carries the operands' storage dtype)."""
    r_ax, c_ax = axes
    arow = D.all_gather(a, mesh, c_ax, 1)       # (M/r, K/c) -> (M/r, K)
    bcol = D.all_gather(b, mesh, r_ax, 0)       # (K/r, N/c) -> (K, N/c)
    return _local_mm(arow, bcol, policy)


# --------------------------------------------------------------------------
# auto dispatch — the remapping service
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GemmPlan:
    algorithm: str
    a_relayout: Optional[Layout]
    b_relayout: Optional[Layout]
    out_layout: Layout
    est_bytes: int                      # analytic wire bytes per device

    def describe(self) -> str:
        return (f"{self.algorithm} (A->{self.a_relayout} B->{self.b_relayout} "
                f"C={self.out_layout}, ~{self.est_bytes/2**20:.1f} MiB/device)")


def _est(shape, dtype, src, dst, mesh):
    if src == dst or dst is None:
        return 0
    return collective_bytes_estimate(shape, dtype, src, dst, mesh)


def gemm_candidates(a_shape, b_shape, dtype: torch.dtype,
                    a_layout: Layout, b_layout: Layout, mesh,
                    out_layout: Optional[Layout] = None,
                    axis: str = "model") -> List[GemmPlan]:
    """Every algorithm that divides the GLOBAL shapes, costed with the
    reference's analytic collective model, cheapest first (the first is
    :func:`plan_gemm`'s)."""
    m, k = a_shape
    k2, n = b_shape
    assert k == k2, f"inner dims mismatch {a_shape} x {b_shape}"
    rep = Layout.replicated(2)
    row = Layout.row_sharded(2, axis)
    col = Layout.col_sharded(2, axis)
    item = dtype.itemsize
    out_bytes = m * n * item

    cands = []

    def add(alg, a_to, b_to, c_layout, extra=0):
        cost = (_est(a_shape, dtype, a_layout, a_to, mesh)
                + _est(b_shape, dtype, b_layout, b_to, mesh) + extra)
        relayouts = int(a_to is not None and a_to != a_layout) \
            + int(b_to is not None and b_to != b_layout)
        if out_layout is not None and c_layout != out_layout:
            cost += _est((m, n), dtype, c_layout, out_layout, mesh)
            relayouts += 1
            c_final = out_layout
        else:
            c_final = c_layout
        cands.append((relayouts, GemmPlan(alg, a_to, b_to, c_final, cost)))

    nmodel = mesh.shape.get(axis, 1)
    if m % nmodel == 0:
        add("row_par", row, rep, row)
    if n % nmodel == 0:
        add("col_par", rep, col, col)
    if k % nmodel == 0:
        add("inner_psum", col, row, rep,
            extra=out_bytes * (nmodel - 1) // nmodel)
        if m % nmodel == 0:
            add("inner_rs", col, row, row,
                extra=(out_bytes // nmodel) * (nmodel - 1) // nmodel)
    daxis = "data"
    if daxis in mesh.shape and axis in mesh.shape:
        r, c = mesh.shape[daxis], mesh.shape[axis]
        if m % r == 0 and k % (r * c) == 0 and n % c == 0:
            blocked = Layout.blocked_2d((daxis, axis))
            ag_a = (m // r) * k * item * (c - 1) // c
            ag_b = k * (n // c) * item * (r - 1) // r
            add("summa2d", blocked, blocked, blocked, extra=ag_a + ag_b)
    add("local", rep, rep, rep)

    # cheapest wire first, with a 5% penalty per relayout (an extra
    # collective the byte model does not see); exact ties go to fewer
    # relayouts
    cands.sort(key=lambda rp: (rp[1].est_bytes * (1 + 0.05 * rp[0]), rp[0]))
    return [plan for _, plan in cands]


def plan_gemm(a_shape, b_shape, dtype: torch.dtype,
              a_layout: Layout, b_layout: Layout, mesh,
              out_layout: Optional[Layout] = None,
              axis: str = "model") -> GemmPlan:
    """Choose the cheapest algorithm + relayouts for (a_layout, b_layout)
    of the GLOBAL shapes, as the reference does.  Ties break toward fewer
    relayouts; any input pair yields a correct plan."""
    return gemm_candidates(a_shape, b_shape, dtype, a_layout, b_layout, mesh,
                           out_layout, axis)[0]


_ALGOS = {
    "row_par": gemm_row_parallel,
    "col_par": gemm_col_parallel,
    "inner_psum": gemm_inner_psum,
    "inner_rs": gemm_inner_rs,
}


def native_layout(algorithm: str, axis: str = "model") -> Layout:
    """The layout an algorithm leaves C in (``local``: replicated)."""
    return {"row_par": Layout.row_sharded(2, axis),
            "col_par": Layout.col_sharded(2, axis),
            "inner_psum": Layout.replicated(2),
            "inner_rs": Layout.row_sharded(2, axis),
            "summa2d": Layout.blocked_2d(("data", axis)),
            "local": Layout.replicated(2)}[algorithm]


def gemm_auto(a: torch.Tensor, b: torch.Tensor,
              a_layout: Layout, b_layout: Layout, mesh,
              out_layout: Optional[Layout] = None, axis: str = "model",
              policy: precision.Policy = precision.MIXED,
              cache=GLOBAL_CACHE) -> Tuple[torch.Tensor, GemmPlan]:
    """Distributed GEMM for arbitrary operand layouts: this rank's blocks
    of A and B in, its block of C out, as ``(C, plan)``.  The plan is
    memoized by semantic key; re-issuing the same op replays it."""
    key = cache.key_for("gemm_auto", (a, b), (a_layout, b_layout, out_layout),
                        tuple(mesh.shape.items()), axis=axis)
    plan = cache.get_or_build(
        key, "gemm_auto",
        lambda: plan_gemm(a_layout.global_shape(a.shape, mesh),
                          b_layout.global_shape(b.shape, mesh), a.dtype,
                          a_layout, b_layout, mesh, out_layout, axis))

    if plan.a_relayout is not None and plan.a_relayout != a_layout:
        a = relayout_explicit(a, a_layout, plan.a_relayout, mesh)
    if plan.b_relayout is not None and plan.b_relayout != b_layout:
        b = relayout_explicit(b, b_layout, plan.b_relayout, mesh)

    if plan.algorithm == "local":
        c = precision.matmul(a, b, policy=policy)
    elif plan.algorithm == "summa2d":
        c = gemm_summa2d(a, b, mesh, axes=("data", axis), policy=policy)
    else:
        c = _ALGOS[plan.algorithm](a, b, mesh, axis=axis, policy=policy)

    # the reference leaves this move to a sharding constraint; C is in the
    # algorithm's own layout until it is moved
    cur = native_layout(plan.algorithm, axis)
    if out_layout is not None and cur != out_layout:
        c = relayout_explicit(c, cur, out_layout, mesh)
    return c, plan


def sharded_matmul(x: torch.Tensor, w: torch.Tensor, w_layout: Layout,
                   mesh, out_layout: Optional[Layout] = None,
                   x_layout: Optional[Layout] = None,
                   policy: precision.Policy = precision.MIXED
                   ) -> torch.Tensor:
    """``x @ w`` with the weight's storage layout and the wanted output
    layout as hints (the reference's GSPMD model path).  Without a
    partitioner it is :func:`gemm_auto` on this rank's blocks, ``x``
    replicated unless ``x_layout`` says otherwise."""
    x_layout = x_layout or Layout.replicated(2)
    return gemm_auto(x, w, x_layout, w_layout, mesh, out_layout=out_layout,
                     policy=policy)[0]
