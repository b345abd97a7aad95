"""The roofline: the card's peak rates, each kernel's FLOPs and HBM bytes
from its shapes, and the reference's fusion gate, ported from the
reference's ``kernels/roofline.py``.

The reference gates its dispatch on this model: an op whose arithmetic
intensity (FLOPs per HBM byte of the unfused composition) sits below the
device's ridge point is memory bound, so a fusion that removes HBM round
trips wins about ``bytes_ref / bytes_fused``; above the ridge the unfused
path keeps the matrix units busy.  Here :func:`gate` is a report only:
``kernels/ops.py`` dispatches by the tensors' device alone, since a gate
on the card would be a hidden fallback to the plain versions.

:data:`HBM_BYTES_PER_S` is the H100's (the reference's is a TPU v5e's);
:func:`ridge_intensity` keeps the reference's rule against
``pipeline/costs.device_flops()``, which stays the reference's nominal
(or a fitted rate) so that the planner's choices equal the reference's.
The card's own peaks are :data:`BF16_FLOPS`, :data:`TF32_FLOPS` and
:data:`FP32_FLOPS`, so its bf16 ridge is ``BF16_FLOPS / HBM_BYTES_PER_S``
(~295 FLOPs a byte).

The ``*_cost`` functions give (HBM bytes, FLOPs) of one kernel call from
its shapes: each input read once, each output written once, and the
kernel's arithmetic.  ``chip_smoke.py`` turns them into each kernel's
bound (:func:`bound`); the dry run (``launch/dryrun.py``) adds them up
for the kernel calls a step would launch, in :data:`DRY`.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

#: bytes/s of HBM, H100 SXM (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
TF32_FLOPS = 495e12                # dense TF32 tensor-core peak
FP32_FLOPS = 67e12                 # fp32 outside the tensor cores
L2_BYTES = 50e6                    # the H100's L2


def ridge_intensity() -> float:
    """FLOPs/byte at which compute time equals memory time, at
    ``pipeline/costs.device_flops()`` (the reference's rule)."""
    from repro_torch.pipeline import costs
    return costs.device_flops() / HBM_BYTES_PER_S


def bound(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS
          ) -> Tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it: the
    larger of ``nbytes`` over :data:`HBM_BYTES_PER_S` and ``flops`` over
    ``flops_per_s``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# each kernel's (bytes, FLOPs) from its shapes
# ---------------------------------------------------------------------------

def matmul_cost(M: int, K: int, N: int, a_itemsize: int = 2,
                b_itemsize: int = 2, c_itemsize: int = 4, batch: int = 1
                ) -> Tuple[float, float]:
    """(M, K) @ (K, N): A and B read, C written; 2MNK FLOPs.  ``batch``
    such products (the batched mode: an expert bank)."""
    return (batch * (a_itemsize * M * K + b_itemsize * K * N
                     + c_itemsize * M * N),
            2.0 * batch * M * N * K)


def matmul_dequant_cost(M: int, K: int, N: int, a_itemsize: int
                        ) -> Tuple[float, float]:
    """(M, K) @ int8 (K, N) times an fp32 scale (N,) into fp32 C."""
    return (a_itemsize * M * K + K * N + 4 * N + 4 * M * N,
            2.0 * M * N * K)


def causal_pairs(S: int, T: int, q_offset: int = 0,
                 window=None) -> int:
    """(query, key) pairs a causal call attends: query i (at position
    ``q_offset + i``) sees keys up to its position, within ``window`` of
    it when one is given."""
    p1 = np.arange(q_offset + 1, q_offset + S + 1)
    lo = np.maximum(0, p1 - window) if window else 0
    return int(np.maximum(0, np.minimum(T, p1) - lo).sum())


def attention_cost(q_shape: Sequence[int], k_shape: Sequence[int],
                   pairs: int, itemsize: int = 2, lse: bool = False
                   ) -> Tuple[float, float]:
    """The flash forward: q, k, v read, out written (and the fp32
    log-sum-exp with ``lse``); QKᵀ and PV over ``pairs`` (query, key)
    pairs of each head."""
    B, H, S, D = q_shape
    qn, kn = B * H * S * D, 1
    for d in k_shape:
        kn *= d
    return (itemsize * (2 * qn + 2 * kn) + (4 * B * H * S if lse else 0),
            4.0 * B * H * pairs * D)


def attention_backward_cost(q_shape: Sequence[int], k_shape: Sequence[int],
                            pairs: int) -> Tuple[float, float]:
    """The flash backward (bf16): q, out and dO read, dQ written (3 of q's
    size), k, v read and dK, dV written (4 of k's), the fp32 log-sum-exp
    read; QKᵀ and dP recomputed, dV, dK and dQ: 5 products."""
    B, H, S, D = q_shape
    qn, kn = B * H * S * D, 1
    for d in k_shape:
        kn *= d
    return (2 * (3 * qn + 4 * kn) + 4 * B * H * S,
            5 * 2.0 * B * H * pairs * D)


def paged_decode_cost(B: int, Hq: int, Hkv: int, hd: int, live: int,
                      table_numel: int) -> Tuple[float, float]:
    """One decode token per sequence against ``live`` cached positions in
    all (the live pages read; the table and lengths): q read and out
    written in bf16, K and V of every live position, QKᵀ and PV."""
    return (2 * (2 * B * Hq * hd) + 2 * 2 * live * Hkv * hd
            + 4 * (table_numel + B), 4.0 * Hq * hd * live)


def paged_partials_cost(B: int, Hq: int, Hkv: int, hd: int, live: int,
                        table_numel: int, splits: int, live_splits: int
                        ) -> Tuple[float, float]:
    """The shard-mode call of the paged decode (one rank's shard of the
    sequence): q read, K and V of this rank's ``live`` positions, the
    table and lengths; every split's fp32 m and l written, o only for the
    ``live_splits`` (sequence, split) pairs with a live key on this rank
    (a dead split's o is never written); QKᵀ and PV."""
    return (2 * B * Hq * hd + 2 * 2 * live * Hkv * hd
            + 4 * (table_numel + B) + 4 * 2 * B * Hq * splits
            + 4 * Hq * live_splits * hd,
            4.0 * Hq * hd * live)


def paged_combine_cost(n: int, B: int, Hq: int, hd: int, splits: int,
                       live_splits: int) -> Tuple[float, float]:
    """The combine of ``n`` ranks' partials: every split's m and l read,
    o only for the ``live_splits`` (rank, sequence, split) triples with a
    live key (l > 0), the bf16 output written; a rescale and add per o
    element read."""
    return (4 * 2 * n * B * Hq * splits + 4 * Hq * live_splits * hd
            + 2 * B * Hq * hd,
            3.0 * Hq * live_splits * hd)


def ssd_cost(B: int, S: int, H: int, P: int, G: int, N: int,
             itemsize: int, init_state: bool, chunk: int = 64
             ) -> Tuple[float, float]:
    """The chunked SSD scan: x and y, B and C in the inputs' type, dt and
    A, the fp32 final state (and the initial one) read or written once;
    per chunk of q steps CBᵀ and the scores' product on the causal
    triangle, the state's read and update."""
    nbytes = itemsize * (2 * B * S * H * P + 2 * B * S * G * N) \
        + 4 * (B * S * H + H + B * H * P * N * (2 if init_state else 1))
    flops = 0.0
    for t0 in range(0, S, chunk):
        q = min(chunk, S - t0)
        tri = q * (q + 1) // 2
        flops += B * H * (2 * tri * N + 2 * tri * P + 4 * q * N * P)
    return nbytes, flops


def ssd_backward_cost(B: int, S: int, H: int, P: int, G: int, N: int,
                      itemsize: int, init_state: bool, d_state: bool,
                      chunk: int = 64) -> Tuple[float, float]:
    """The SSD scan's backward: x, dy and dx, B, C, dB and dC in the
    inputs' type, dt, ddt, A and dA, the fp32 final-state cotangent (when
    given) and d init_state (with an initial state) read or written once;
    per chunk of q steps the five products on the causal triangle (C Bᵀ,
    dy uᵀ, dC's and dB's diagonal terms, du's) and the four over the
    whole (P, N) state (dy H, dH, B dSᵀ, dB's state term)."""
    nbytes = itemsize * (3 * B * S * H * P + 4 * B * S * G * N) \
        + 4 * (2 * B * S * H + 2 * H
               + B * H * P * N * (int(init_state) + int(d_state)))
    flops = 0.0
    for t0 in range(0, S, chunk):
        q = min(chunk, S - t0)
        tri = q * (q + 1) // 2
        flops += B * H * (2 * tri * (3 * N + 2 * P) + 8 * q * N * P)
    return nbytes, flops


def quantize_int8_cost(n: int) -> Tuple[float, float]:
    """fp32 x read, int8 q written: 5 bytes and 3 operations an element."""
    return 5.0 * n, 3.0 * n


def quantize_compress_cost(n: int, itemsize: int) -> Tuple[float, float]:
    """x read, int8 q and the fp32 scale written; the absmax and the
    rounding."""
    return (itemsize + 1.0) * n + 4, 6.0 * n


def quantize_compress_ef_cost(n: int, g_itemsize: int
                              ) -> Tuple[float, float]:
    """g and the fp32 error read, the fp32 dequantized value and new
    error written, and the scale: v = g + err quantized."""
    return (g_itemsize + 12.0) * n + 4, 8.0 * n


# ---------------------------------------------------------------------------
# the dry run's kernel counts
# ---------------------------------------------------------------------------

class KernelCounts:
    """FLOPs, HBM bytes and calls of the kernels the wrappers would have
    launched, by op, since the last :meth:`reset` (the wrappers' shape
    functions record here when they are handed fake tensors)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.flops: Dict[str, float] = collections.defaultdict(float)
        self.bytes: Dict[str, float] = collections.defaultdict(float)
        self.calls: Dict[str, int] = collections.defaultdict(int)

    def record(self, op: str, cost: Tuple[float, float]) -> None:
        self.bytes[op] += cost[0]
        self.flops[op] += cost[1]
        self.calls[op] += 1


DRY = KernelCounts()


# ---------------------------------------------------------------------------
# the reference's gate (a report here)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GateDecision:
    """One gating verdict."""

    op: str
    fused: bool
    intensity: float            # FLOPs / reference HBM byte
    ridge: float
    bytes_ref: int
    bytes_fused: int
    reason: str

    def to_dict(self) -> Dict:
        return {"op": self.op, "fused": self.fused,
                "intensity": round(self.intensity, 3),
                "ridge": round(self.ridge, 3),
                "bytes_ref": self.bytes_ref,
                "bytes_fused": self.bytes_fused,
                "reason": self.reason}


def gate(op: str, *, flops: float, bytes_ref: int,
         bytes_fused: int) -> GateDecision:
    """Would the fusion pay for one op instance?  ``bytes_ref`` is the
    HBM traffic of the unfused composition (every intermediate it
    materializes included), ``bytes_fused`` the fused kernel's.  Fused
    wins when the op is memory bound AND the fusion removes bytes."""
    ridge = ridge_intensity()
    intensity = flops / max(1, bytes_ref)
    if bytes_fused >= bytes_ref:
        return GateDecision(op, False, intensity, ridge, int(bytes_ref),
                            int(bytes_fused), "fusion saves no bytes")
    if intensity >= ridge:
        return GateDecision(op, False, intensity, ridge, int(bytes_ref),
                            int(bytes_fused),
                            "compute bound: XLA reference keeps MXU busy")
    return GateDecision(op, True, intensity, ridge, int(bytes_ref),
                        int(bytes_fused),
                        f"memory bound ({intensity:.2f} < ridge "
                        f"{ridge:.0f} FLOPs/B): fusion cuts "
                        f"{bytes_ref - bytes_fused} HBM bytes")
