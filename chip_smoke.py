#!/usr/bin/env python3
"""Drive the PyTorch/H100 port once on the card: ``python3 chip_smoke.py``.

Run from the root of a checkout, on a machine with one NVIDIA H100, the
CUDA toolkit (``nvcc``) and PyTorch built for CUDA.  Imports nothing of JAX
or of the JAX package.  Phases, in order; any failure exits non-zero:

1. Device facts: name, count, and ``nvidia-smi``'s name and power limit.
2. Build the kernels from ``src/repro_torch/kernels/csrc`` (nvcc, one
   process per source, in parallel) and report the seconds.
3. Each kernel at the serve path's shapes against its plain PyTorch
   version on the same inputs (bf16 tolerance: |err| <= 2e-2 + 3e-2·|ref|),
   its device time (a CUDA graph of many calls, timed with CUDA events),
   its bound from shapes (bytes / 3.35 TB/s or FLOPs / 989 TFLOP/s, the
   larger), the plain version's time, and the time of one PyTorch library
   call computing the same function where there is one (timed only; the
   port never calls it).
   The GEMM runs each qwen2 product at a decode step's M = 8 and a
   prefill chunk's M = 128, printing its plan (regime, tile, split), and
   both sums are timed beside ``torch.matmul``.  Then the GEMM's design
   properties at full width: rows of a 1,024-row product equal the
   product of those rows alone at M = 1, 8, 44, 64, 65, 128, 300 and
   1,024, bitwise, for every (K, N) of qwen2-0.5b and mamba2-780m and two
   ragged ones, in bf16 and fp32; repeated runs give the same bits; A and
   B passed transposed, as the backward passes them, give the bits of
   contiguous copies at every train shape; fp32 operands (unit variance,
   not bf16 values) stay within the reference's fp32 tolerance (rtol
   1e-5, atol 1e-2), which ``torch.matmul`` with TF32 allowed must fail
   at every model K and N of 128 and up (a control).
   Then flash attention's properties at qwen2-0.5b's heads: a
   300-token prompt in one call and chunk by chunk as the paged prefill
   runs it give every row the same output and log-sum-exp, bitwise (with
   and without a window and a softcap); the forward with its
   log-sum-exp and the backward at the train shape give the same bits
   run to run; fp32 q, k, v (the CUDA-core kernel) stay within rtol 2e-5,
   atol 2e-2 of the plain version.
   The SSD scan is checked at mamba2-780m's prefill shapes (bf16 and fp32
   inputs, S = 512 and a ragged 300, two groups, an initial state) at the
   reference SSD test's tolerances, and bounded by fp32 or bf16 peak FLOP/s
   by its inputs' type; for fp32 inputs the TF32 tensor-core bound is
   printed beside it.
4. Serve qwen2-0.5b at full width (random weights from a seed) through
   ``ContinuousEngine``: 16 requests, prompts of 64-512 tokens, 64 new
   tokens each.  Launch counts are zeroed just before and read just after;
   each kernel must have run, exactly as often as the model's layer loop
   says.  The same requests through the static paged ``Engine`` must give
   identical greedy tokens, and the card's logits must agree with the
   plain versions' on the CPU on a short prompt.  One decode step is also
   split into its host wall time and its device time.
5. Serve mamba2-780m at full width (48 layers) through the dense-cache
   static ``Engine`` (8 slots, the same 16-request set), with its own
   launch-count check (``matmul`` 241 per prefill and per decode step,
   ``ssd`` 48 per prefill); hold the GEMM kernel against its plain
   version at each mamba2 product's shape, at M = 8 (a decode step) and
   at a ragged prefill M = 300, and time them beside ``torch.matmul``;
   split a decode step into
   GEMM, the plain ``ssd_step`` and convolutions, other device work and
   host time; hold the card's prefill states and logits against the
   CPU's (with controls that must fail), and prefill-then-decode against
   the full forward.
6. Train qwen2-0.5b at full width (24 layers) through ``Session``.  The
   train kernels first: ``quantize_int8`` bitwise against its plain
   version at each of the int8 wire's 9 bucket lengths, a ragged length,
   exact .5 ties and a zero bucket; the attention backward kernel (and the
   forward with its log-sum-exp) at the train shape and at ragged, window,
   softcap and fully-masked shapes, the forward timed beside its bound
   and SDPA at the train shape; the GEMM's backward products at every
   train shape, on the transposed views the backward passes; each timed
   beside its bound, its plain version and a library call.  Then run 2,
   one rank without a wire (``comms="off"``) on 4 x 512 tokens of
   ``SyntheticLM(structured=True)``, with its launch
   counts; the card's 2-layer loss and gradients against the CPU's; and
   two ranks spawned on the one card over gloo: run 3 (fp32 wire, one
   step, held to run 2) and run 4, the main path (int8 wire, 6 steps):
   replicas bitwise equal after every step, step 1 held to run 3, the loss
   falling, launches per rank equal to the layer loop's (9
   ``quantize_int8`` per step), a bucket recomputed on the host equal to
   the wire's and a control without one rank's contribution that must
   differ; step, device, host, wire and optimizer times, tokens per
   second, wire bytes and peak memory per rank.
7. The compressed data-parallel SGD path at full width.  The kernels
   first: ``quantize_compress`` bitwise (q and scale) against its plain
   version at each of qwen2-0.5b's 15 leaf lengths (timed), ragged
   lengths, a bf16 input, an all-zero input, exact .5 ties and a
   negative absmax; ``matmul_dequant`` (reached through
   ``ops.matmul_dequant`` only: no model path calls it) at the reference
   test's tolerances (fp32 2e-5, bf16 2e-2), bf16 and fp32 activations,
   at qwen2-0.5b's eight decode products (M = 8, timed as one decode
   step's 169), at a prefill M = 128, the bench shape (8, 1024, 1024) and
   the ragged shapes, timed beside ``torch.matmul`` on the weights
   widened beforehand (a yardstick only).  Then two ranks spawned on the
   card over gloo run ``train.compression.build_dp_sgd_step`` over the
   model's loss for the schemes ``none``, ``onebit`` and ``int8``, 3
   steps each from the seed (lr 0.1, momentum 0.9, 4 x 512 tokens of
   ``SyntheticLM(structured=True)`` a step), each scheme a counted
   window: params and velocity bitwise equal on both ranks after every
   step (the error state is each rank's own); launches per rank equal to
   the layer loop's (``quantize_compress`` 15 per int8 step, 0 for the
   other schemes); ``none``'s step-1 synced gradients the bf16 mean of
   the local gradients computed alone, bitwise; int8's within (s0 +
   s1) / 4 of their fp32 mean, plus fp32 rounding; error feedback exact
   (int8: deq + err equals v bitwise or within one fp32 spacing; onebit
   within rtol 1e-5); the first batch's loss lower after ``none``'s
   steps; step, wire and quantizer times, tokens per second, wire bytes
   and peak memory per rank.
8. Print the ``kernels`` JSON line, the card's name and power limit, and
   last the ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import gemm as gemm_mod  # noqa: E402
from repro_torch.kernels import paged_attention as paged_mod  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.models import Model, ssm  # noqa: E402
from repro_torch.serve import ContinuousEngine, Engine, Request  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
TF32_FLOPS = 495e12                # dense TF32 tensor-core peak
FP32_FLOPS = 67e12                 # fp32 outside the tensor cores
L2_BYTES = 50e6
RTOL, ATOL = 3e-2, 2e-2            # bf16: 8 mantissa bits, fp32 sums
# the reference's SSD test (tests/test_kernels.py): the same fp32 math in
# another order; y stored in bf16
SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
SSD_Q = 64                         # the SSD kernel's chunk (csrc/ssd_scan.cu)
# Card against CPU at full depth, in fractions of the largest logit.  The
# CPU parity test measures 0.17% at 8 mamba2 layers (one bf16 rounding of
# the residual stream falling the other way,
# tests/test_torch_ssm.py::test_prefill_matches_reference); growing
# linearly with depth that is ~1% at 48, and the card, whose GEMM sums in
# another order in every product, flips more roundings than XLA against
# PyTorch on the CPU: 5%, as for qwen2 (0.32% at 2 layers, 2.29% measured
# at 24).
LOGIT_TOL = 5e-2
# States against states computed from the same inputs, in fractions of the
# state's largest magnitude: the same fp32 math in another order, except
# where a bf16 rounding (of the residual stream, or of a conv state stored
# in bf16) falls the other way and moves a value by 2^-8 of itself.  Holds
# prefill + decode against the forward, and the first layer's prefill
# states on the card against the CPU's (its inputs are the same embedding
# rows in both; every layer runs the same kernels at the same shapes, so
# a wrong scan shows there).  Deeper layers' states, card against CPU, are
# printed, not held to a tolerance: their drift is the residual stream's,
# grown with depth (on an H100, up to 5.5% relative RMS in the SSM state
# of the worst layer, 3.4-3.5% in the conv inputs), and the logit check
# bounds that stream at the last layer.
STATE_TOL = 1e-2

ARCH = "qwen2-0.5b"
MAMBA = "mamba2-780m"
MAMBA_PARAMS = 857_293_056
PREFILL_M = 300                    # a ragged prompt: 4 GEMM row tiles + 44
SEED = 0
N_REQUESTS, PROMPT_MIN, PROMPT_MAX, NEW_TOKENS = 16, 64, 512, 64
SLOTS, MAX_SEQ, PAGE, CHUNK = 8, 1024, 64, 128


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def bound(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(calls, iters: int, warmup: int = 3) -> float:
    """Device ms per call: ``iters`` calls captured in one CUDA graph and
    timed with CUDA events over its replay (the median of 3), so the host's
    launch overhead does not show in a kernel's time.  ``calls`` rotates
    over copies of the inputs large enough together to overflow the 50 MB
    L2, as on the serve path, where each layer's weights and pages arrive
    cold."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(warmup):
            calls[i % len(calls)]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            calls[i % len(calls)]()
    graph.replay()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times)


def copies(nbytes: float) -> int:
    return max(1, min(64, math.ceil(2 * L2_BYTES / max(nbytes, 1.0))))


def max_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    got, want = got.float(), want.float()
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = (got - want).abs()
    bad = err > ATOL + RTOL * want.abs()
    require(not bool(bad.any()),
            f"{what}: kernel disagrees with its plain version "
            f"(max abs err {float(err.max()):.3g})")
    return float(err.max())


def gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def randn(shape, seed: int, scale: float = 1.0,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    x = torch.randn(shape, generator=gen(seed), device="cuda")
    return (x * scale).to(dtype)


def fp32_close(got: torch.Tensor, want: torch.Tensor):
    """(within the reference kernel test's fp32 tolerance, rtol 1e-5 and
    atol 1e-2 (``tests/test_kernels.py``); the max abs error)."""
    err = (got - want).abs()
    return not bool((err > 1e-2 + 1e-5 * want.abs()).any()), float(err.max())


# ---------------------------------------------------------------------------
# phase 3: the kernels at the serve path's shapes
# ---------------------------------------------------------------------------

def gemm_cases(cfg):
    """(label, K, N, calls per decode step) of every product the model
    runs; a prefill chunk runs the same set at M = CHUNK."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    q, kv = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    L = cfg.n_layers
    return [("q", D, q, L), ("k", D, kv, L), ("v", D, kv, L),
            ("o", q, D, L), ("gate", D, F, L), ("in", D, F, L),
            ("out", F, D, L), ("unembed", D, V, 1)]


def plan_label(M, K, N, **kw) -> str:
    pl = gemm_mod.plan(M, K, N, **kw)
    return f"{pl.regime} {pl.tile_m}x{pl.tile_n} split {pl.split}"


def check_gemm(cfg):
    """Each qwen2 product at a decode step's M and a prefill chunk's, with
    its plan (regime, tile, split): against the plain version, timed with
    L2-cold weights beside the bound, the plain version and
    ``torch.matmul``; returns the row with the decode step's sums and the
    prefill chunk's."""
    sums = {M: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                    bytes=0.0, flops=0.0) for M in (SLOTS, CHUNK)}
    errs = []
    print("gemm: M K N | plan | kernel ms | bound ms (by) | plain ms | "
          "torch.matmul ms | max abs err")
    for M in (SLOTS, CHUNK):
        for i, (label, K, N, calls) in enumerate(gemm_cases(cfg)):
            nbytes = 2 * (M * K + K * N) + 4 * M * N
            flops = 2.0 * M * N * K
            n = copies(2 * K * N)
            a = randn((M, K), 100 + i)
            bs = [randn((K, N), 200 + i + 17 * j, 0.05) for j in range(n)]
            err = max_err(gemm_mod.matmul(a, bs[0], torch.float32),
                          ref.matmul(a, bs[0], torch.float32),
                          f"gemm {label} M={M}")
            errs.append(err)
            ms = cuda_ms([lambda b=b: gemm_mod.matmul(a, b, torch.float32)
                          for b in bs], iters=max(20, 4 * n))
            plain = cuda_ms([lambda b=b: ref.matmul(a, b, torch.float32)
                             for b in bs[:2]], iters=5, warmup=1)
            lib = cuda_ms([lambda b=b: torch.matmul(a, b) for b in bs],
                          iters=max(20, 4 * n))
            bms, by = bound(nbytes, flops)
            print(f"gemm {label:7s} {M:4d} {K:5d} {N:6d} | "
                  f"{plan_label(M, K, N)} | {ms:.4f} | {bms:.4f} ({by}) | "
                  f"{plain:.4f} | {lib:.4f} | {err:.3g}")
            for key, val in (("ms", ms), ("plain_ms", plain),
                             ("library_ms", lib), ("bound_ms", bms),
                             ("bytes", nbytes), ("flops", flops)):
                sums[M][key] += calls * val
    ncalls = sum(c for *_, c in gemm_cases(cfg))
    rows = {}
    for M, what in ((SLOTS, "one decode step"), (CHUNK, "one prefill chunk")):
        t = sums[M]
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["flops"])
        print(f"gemm: {what} ({ncalls} calls, M={M}): {t['ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), plain "
              f"{t['plain_ms']:.4f} ms, torch.matmul {t['library_ms']:.4f} "
              f"ms ({t['ms'] / t['library_ms']:.2f}x)")
        rows[M] = t
    step, chunk = rows[SLOTS], rows[CHUNK]
    return dict(name="gemm", route="cuda",
                source="src/repro_torch/kernels/csrc/gemm.cu",
                replaces="src/repro/kernels/gemm.py:45",
                case=f"one decode step: the {ncalls} products at M={SLOTS}",
                max_abs_err=max(errs), ms=step["ms"],
                plain_ms=step["plain_ms"], bound_ms=step["bound_ms"],
                bound_by=step["bound_by"], library_ms=step["library_ms"],
                prefill_chunk_ms=chunk["ms"],
                prefill_chunk_library_ms=chunk["library_ms"],
                prefill_chunk_bound_ms=chunk["bound_ms"],
                prefill_chunk_plain_ms=chunk["plain_ms"])


def check_gemm_properties(cfg, mcfg):
    """The kernel's design properties at full width, on the card:
    - row invariance, bitwise: for every (K, N) of qwen2-0.5b and
      mamba2-780m and two ragged ones, rows taken from a 1,024-row product
      equal the product of those rows alone at M = 1, 8, 44, 64, 65, 128,
      300 and 1,024 (every regime, tile and split), bf16 and fp32;
    - run to run, bitwise: three more runs of each 1,024-row product;
    - transposed operands, bitwise: A stored (K, M) and B stored (N, K),
      as the backward passes them, equal the product on contiguous
      copies, at every train shape (bf16 and fp32);
    - fp32 operands within the reference's fp32 tolerance (rtol 1e-5,
      atol 1e-2) of the plain version, on unit-variance operands that are
      not bf16 values, as the reference's test draws them; at every model
      K (896 and up) and N of 128 and up (where cuBLAS takes its tensor
      cores), ``torch.matmul`` with TF32 allowed is a control that must
      fail the same check (its 10 mantissa bits err by ~4e-4 sqrt(K) per
      output).
    Returns the counts of products checked."""
    kn = sorted({(K, N) for _, K, N, _ in gemm_cases(cfg)}
                | {(K, N) for _, K, N, _ in mamba_gemm_cases(mcfg)}
                | {(13, 7), (130, 66)})
    checked = dict(row_invariance=0, run_to_run=0, transposed=0, fp32=0,
                   tf32_control=0)
    fp32_err, tf32_err = 0.0, math.inf   # the kernel's worst, TF32's least
    for K, N in kn:
        for dt in (torch.bfloat16, torch.float32):
            a = randn((1024, K), 1700 + K, dtype=dt)
            b = randn((K, N), 1701 + N, dtype=dt)
            full = gemm_mod.matmul(a, b, torch.float32)
            for m in (1, 8, 44, 64, 65, 128, 300, 1024):
                rows = torch.randperm(1024, generator=gen(m),
                                      device="cuda")[:m]
                part = gemm_mod.matmul(a[rows].contiguous(), b,
                                       torch.float32)
                require(torch.equal(part, full[rows]),
                        f"gemm rows depend on M: K={K} N={N} {dt} M={m} "
                        f"({plan_label(m, K, N, f32=dt == torch.float32)})"
                        f", {int((part != full[rows]).sum())} differ")
                checked["row_invariance"] += 1
            for _ in range(3):
                require(torch.equal(gemm_mod.matmul(a, b, torch.float32),
                                    full),
                        f"gemm K={K} N={N} {dt}: two runs differ")
                checked["run_to_run"] += 1
            if dt == torch.float32:
                want = ref.matmul(a, b, torch.float32)
                ok, err = fp32_close(full, want)
                require(ok, f"gemm fp32 K={K} N={N}: beyond rtol 1e-5, "
                        f"atol 1e-2 (max abs err {err:.3g})")
                checked["fp32"] += 1
                fp32_err = max(fp32_err, err)
                if K >= 896 and N >= 128:
                    tf32 = torch.backends.cuda.matmul.allow_tf32
                    torch.backends.cuda.matmul.allow_tf32 = True
                    try:
                        control = torch.matmul(a, b)
                    finally:
                        torch.backends.cuda.matmul.allow_tf32 = tf32
                    ok, err = fp32_close(control, want)
                    require(not ok, f"gemm fp32 K={K} N={N}: the check "
                            f"cannot see TF32 (max abs err {err:.3g})")
                    checked["tf32_control"] += 1
                    tf32_err = min(tf32_err, err)
            del full
    M = TRAIN_BATCH // RANKS * TRAIN_SEQ
    for _, K, N, _ in gemm_cases(cfg):
        for dt in (torch.bfloat16, torch.float32):
            a = randn((M, K), 1720 + K, dtype=dt)
            b = randn((K, N), 1721 + N, 0.05, dtype=dt)
            dc = randn((M, N), 1722 + N, dtype=dt)
            for x, y in ((dc, b.t()), (a.t(), dc)):
                got = gemm_mod.matmul(x, y, torch.float32)
                want = gemm_mod.matmul(x.contiguous(), y.contiguous(),
                                       torch.float32)
                require(torch.equal(got, want),
                        f"gemm transposed operands differ from copies: "
                        f"{tuple(x.shape)} @ {tuple(y.shape)} {dt}")
                checked["transposed"] += 1
    print(f"gemm properties: {checked} products checked, all bitwise; "
          f"fp32 within tolerance (max abs err at most {fp32_err:.3g}), "
          f"every TF32 control beyond it (max abs err at least "
          f"{tf32_err:.3g})", flush=True)
    return checked


def sdpa_mask(S, T, q_offset):
    qpos = torch.arange(S, device="cuda")[:, None] + q_offset
    return torch.arange(T, device="cuda")[None, :] <= qpos


def check_flash(cfg):
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    errs, row = [], None
    print("flash: start T | kernel ms | bound ms (by) | plain ms | sdpa ms "
          "| max abs err")
    for start in range(0, PROMPT_MAX, CHUNK):
        T = start + CHUNK             # the chunk's live pages, gathered
        qs = H * CHUNK * hd
        nbytes = 2 * (2 * qs + 2 * Hkv * T * hd)
        pairs = CHUNK * start + CHUNK * (CHUNK + 1) // 2    # causal, visible
        flops = 4.0 * H * pairs * hd
        n = copies(nbytes)
        sets = [(randn((1, H, CHUNK, hd), 300 + j),
                 randn((1, Hkv, T, hd), 400 + j),
                 randn((1, Hkv, T, hd), 500 + j)) for j in range(n)]
        kw = dict(causal=True, q_offset=start)
        q, k, v = sets[0]
        err = max_err(fa_mod.attention(q, k, v, **kw),
                      ref.attention(q, k, v, **kw), f"flash start={start}")
        errs.append(err)
        ms = cuda_ms([lambda s=s: fa_mod.attention(*s, **kw) for s in sets],
                     iters=max(20, 2 * n))
        plain = cuda_ms([lambda s=s: ref.attention(*s, **kw)
                         for s in sets[:2]], iters=5, warmup=1)
        mask = sdpa_mask(CHUNK, T, start)
        lib = cuda_ms([lambda s=s: torch.nn.functional
                       .scaled_dot_product_attention(
                           *s, attn_mask=mask, enable_gqa=True)
                       for s in sets], iters=max(20, 2 * n))
        bms, by = bound(nbytes, flops)
        print(f"flash {start:4d} {T:5d} | {ms:.4f} | {bms:.5f} ({by}) | "
              f"{plain:.4f} | {lib:.4f} | {err:.3g}")
        row = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                   bound_by=by, case=f"one prefill chunk: q (1,{H},{CHUNK},"
                   f"{hd}) at q_offset {start} against k/v (1,{Hkv},{T},{hd})")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:87",
                max_abs_err=max(errs), **row)


def chunked_like_paged_prefill(q, k, v, window, softcap):
    """(out, lse) of q (1,H,S,D)'s rows computed chunk by chunk as
    ``models/attention.prefill_chunk_paged`` calls the kernel: CHUNK query
    rows (the last end-padded) at ``q_offset = start`` against the keys
    of the live pages (T a multiple of PAGE; keys past S hold other
    values, as the padding's keys do there)."""
    S, hd = q.shape[2], q.shape[3]
    outs, lses = [], []
    for start in range(0, S, CHUNK):
        n, T = min(CHUNK, S - start), -(-(start + CHUNK) // PAGE) * PAGE
        qc = randn(q.shape[:2] + (CHUNK, hd), 1800 + start)
        kc = randn(k.shape[:2] + (T, hd), 1801 + start)
        vc = randn(v.shape[:2] + (T, hd), 1802 + start)
        qc[:, :, :n] = q[:, :, start:start + n]
        kc[:, :, :min(T, S)] = k[:, :, :T]
        vc[:, :, :min(T, S)] = v[:, :, :T]
        out, lse = fa_mod._forward(qc, kc, vc, True, window, softcap,
                                   hd ** -0.5, start, with_lse=True)
        outs.append(out[:, :, :n])
        lses.append(lse[:, :, :n])
    return torch.cat(outs, 2), torch.cat(lses, 2)


def check_flash_properties(cfg):
    """The attention kernels' design properties at qwen2-0.5b's heads:
    - row invariance, bitwise: a 300-token prompt in one call (S = T =
      300, q_offset 0) and chunk by chunk as the paged prefill runs it
      give every row the same output and log-sum-exp, with no window or
      softcap, a window of 100, a softcap of 30, and both;
    - run to run, bitwise: the forward with its log-sum-exp and the
      backward at the train shape, run twice more on the same inputs;
    - fp32 q, k, v (the CUDA-core kernel) on one prefill chunk within the
      reference kernel test's fp32 tolerance (rtol 2e-5), atol 2e-2,
      timed.
    Returns the counts checked, the fp32 error and time."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    checked = dict(row_invariance=0, run_to_run=0)
    q = randn((1, H, 300, hd), 1810)
    k, v = randn((1, Hkv, 300, hd), 1811), randn((1, Hkv, 300, hd), 1812)
    for window, cap in ((None, None), (100, None), (None, 30.0), (100, 30.0)):
        out, lse = fa_mod._forward(q, k, v, True, window, cap, hd ** -0.5, 0,
                                   with_lse=True)
        c_out, c_lse = chunked_like_paged_prefill(q, k, v, window, cap)
        require(torch.equal(c_out, out) and torch.equal(c_lse, lse),
                f"flash rows depend on the chunking (window {window}, "
                f"softcap {cap}): {int((c_out != out).sum())} outputs and "
                f"{int((c_lse != lse).sum())} log-sum-exps differ")
        checked["row_invariance"] += 1
    B, S = TRAIN_BATCH // RANKS, TRAIN_SEQ
    q, k, v, do = bwd_inputs(1820, B, H, Hkv, S, S, hd)
    args = (True, None, None, hd ** -0.5, 0)
    out, lse = fa_mod._forward(q, k, v, *args, with_lse=True)
    grads = fa_mod.attention_backward(q, k, v, out, do, lse)
    for _ in range(2):
        again = fa_mod._forward(q, k, v, *args, with_lse=True)
        require(torch.equal(again[0], out) and torch.equal(again[1], lse),
                "flash forward: two runs differ")
        require(all(torch.equal(a, b) for a, b in zip(
            fa_mod.attention_backward(q, k, v, out, do, lse), grads)),
            "attention backward: two runs differ")
        checked["run_to_run"] += 2
    start, T = PROMPT_MAX - CHUNK, PROMPT_MAX
    q = randn((1, H, CHUNK, hd), 1830, dtype=torch.float32)
    k = randn((1, Hkv, T, hd), 1831, dtype=torch.float32)
    v = randn((1, Hkv, T, hd), 1832, dtype=torch.float32)
    kw = dict(causal=True, q_offset=start)
    want = ref.attention(q, k, v, **kw)
    err = (fa_mod.attention(q, k, v, **kw) - want).abs()
    require(not bool((err > 2e-2 + 2e-5 * want.abs()).any()),
            f"flash fp32: beyond rtol 2e-5, atol 2e-2 (max abs err "
            f"{float(err.max()):.3g})")
    f32_ms = cuda_ms([lambda: fa_mod.attention(q, k, v, **kw)], iters=20)
    print(f"flash properties: {checked} checks, all bitwise; fp32 one "
          f"chunk within rtol 2e-5, atol 2e-2 (max abs err "
          f"{float(err.max()):.3g}), {f32_ms:.4f} ms", flush=True)
    return dict(checked, fp32_max_abs_err=float(err.max()),
                fp32_chunk_ms=f32_ms)


def check_paged(cfg):
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    n_row = MAX_SEQ // PAGE
    P = 1 + SLOTS * n_row
    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT_MIN, PROMPT_MAX + 1, SLOTS) + NEW_TOKENS // 2
    table = (rng.permutation(P - 1) + 1).reshape(SLOTS, n_row)
    table = torch.from_numpy(table.astype(np.int32)).cuda()
    seq_lens = torch.from_numpy(lens.astype(np.int32)).cuda()
    live = int(lens.sum())
    nbytes = 2 * (2 * SLOTS * H * hd) + 2 * 2 * live * Hkv * hd \
        + 4 * (table.numel() + SLOTS)
    flops = 4.0 * H * hd * live
    n = copies(2 * 2 * P * PAGE * Hkv * hd)
    q = randn((SLOTS, H, hd), 600)
    pools = [(randn((P, PAGE, Hkv, hd), 700 + j),
              randn((P, PAGE, Hkv, hd), 800 + j)) for j in range(n)]
    args = (table, seq_lens)
    err = max_err(paged_mod.paged_decode_attention(q, *pools[0], *args),
                  ref.paged_decode_attention(q, *pools[0], *args),
                  "paged decode")
    ms = cuda_ms([lambda p=p: paged_mod.paged_decode_attention(q, *p, *args)
                  for p in pools], iters=max(20, 2 * n))
    plain = cuda_ms([lambda p=p: ref.paged_decode_attention(q, *p, *args)
                     for p in pools[:2]], iters=5, warmup=1)
    bms, by = bound(nbytes, flops)
    print(f"paged: B={SLOTS} seq_lens={lens.tolist()} | {ms:.4f} ms | bound "
          f"{bms:.5f} ms ({by}) | plain {plain:.4f} ms | {err:.3g}")
    return dict(name="paged_decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:71",
                case=f"one decode step's call: q ({SLOTS},{H},{hd}), pool "
                     f"({P},{PAGE},{Hkv},{hd}), {live} live positions",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=None)


def ssd_inputs(seed: int, S: int, G: int, dtype, init: bool, H=48, P=64,
               N=128):
    """mamba2-780m's prefill shapes, decay drawn as the model's inits
    draw it (A = -U[1, 16], dt log-uniform in [1e-3, 0.1])."""
    g = gen(seed)
    u = torch.rand((1, S, H), generator=g, device="cuda")
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    A = -(1.0 + 15.0 * torch.rand(H, generator=g, device="cuda"))
    x = torch.randn((1, S, H, P), generator=g, device="cuda").to(dtype)
    Bm = torch.randn((1, S, G, N), generator=g, device="cuda").to(dtype)
    C = torch.randn((1, S, G, N), generator=g, device="cuda").to(dtype)
    init_state = (torch.randn((1, H, P, N), generator=g, device="cuda")
                  if init else None)
    return dict(x=x, dt=dt, A=A, Bm=Bm, C=C, init_state=init_state)


def ssd_cost(inp):
    """Bytes (each input read once, each output written once) and the
    dual form's FLOPs at the kernel's chunk over the valid steps: per
    chunk of q steps, C B^T and scores @ (dt x) on the causal triangle,
    (C exp(a)) h and the state update."""
    x, Bm = inp["x"], inp["Bm"]
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    es = x.element_size()
    nbytes = es * (2 * x.numel() + 2 * Bm.numel()) \
        + 4 * (inp["dt"].numel() + H + B * H * P * N
               * (2 if inp["init_state"] is not None else 1))
    flops = 0.0
    for t0 in range(0, S, SSD_Q):
        q = min(SSD_Q, S - t0)
        tri = q * (q + 1) // 2
        flops += B * H * (2 * tri * N + 2 * tri * P + 4 * q * N * P)
    fp32 = x.dtype == torch.float32
    return (nbytes, flops, FP32_FLOPS if fp32 else BF16_FLOPS,
            TF32_FLOPS if fp32 else BF16_FLOPS)


def check_ssd():
    cases = [("bf16 S=512", 512, 1, torch.bfloat16, False),
             ("bf16 ragged S=300", 300, 1, torch.bfloat16, False),
             ("bf16 G=2 S=512", 512, 2, torch.bfloat16, False),
             ("fp32 init_state S=300", 300, 1, torch.float32, True),
             ("fp32 S=512", 512, 1, torch.float32, False)]
    print("ssd: case | kernel ms | bound ms (by) | tensor-core bound ms | "
          "plain ms | max abs err y, state (tolerance)")
    errs, row = [], None
    for i, (label, S, G, dtype, init) in enumerate(cases):
        inp = ssd_inputs(900 + i, S, G, dtype, init)
        y, st = ssd_mod.ssd(**inp)
        yw, sw = ssd_mod.ssd_plain(**inp, chunk=256)
        tol = SSD_TOL[dtype]
        e = []
        for got, want, what in ((y, yw, "y"), (st, sw, "state")):
            got, want = got.float(), want.float()
            require(bool(torch.isfinite(got).all()),
                    f"ssd {label}: non-finite {what}")
            err = (got - want).abs()
            require(not bool((err > tol + tol * want.abs()).any()),
                    f"ssd {label}: {what} disagrees with the plain version "
                    f"(max abs err {float(err.max()):.3g})")
            e.append(float(err.max()))
        errs.append(max(e))
        nbytes, flops, rate, tc_rate = ssd_cost(inp)
        bms, by = bound(nbytes, flops, rate)
        tc = "{:.5f} ({})".format(*bound(nbytes, flops, tc_rate))
        if S == 512 and G == 1:
            n = copies(nbytes)
            sets = [ssd_inputs(950 + j, S, G, dtype, init) for j in range(n)]
            ms = cuda_ms([lambda s=s: ssd_mod.ssd(**s) for s in sets],
                         iters=max(20, 2 * n))
            plain = cuda_ms([lambda s=s: ssd_mod.ssd_plain(**s, chunk=256)
                             for s in sets[:2]], iters=5, warmup=1)
            print(f"ssd {label:22s} | {ms:.4f} | {bms:.5f} ({by}) | {tc} | "
                  f"{plain:.4f} | {e[0]:.3g}, {e[1]:.3g} ({tol:g})")
            if dtype == torch.float32:    # what the serve path gives it
                row = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                           tensor_core_bound_ms=bound(nbytes, flops,
                                                      tc_rate)[0],
                           case=f"one prefill call at S={S}: x (1,{S},48,64)"
                                f" fp32, B/C (1,{S},1,128) fp32")
        else:
            print(f"ssd {label:22s} | - | {bms:.5f} ({by}) | {tc} | - | "
                  f"{e[0]:.3g}, {e[1]:.3g} ({tol:g})")
    return dict(name="ssd", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan.py:81",
                max_abs_err=max(errs), library_ms=None, **row)


# ---------------------------------------------------------------------------
# phase 4: serve at full width
# ---------------------------------------------------------------------------

def requests(cfg):
    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT_MIN, PROMPT_MAX + 1, N_REQUESTS)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, int(n))
                    .astype(np.int32), max_new_tokens=NEW_TOKENS)
            for i, n in enumerate(lens)]


def serve(engine_cls, model, params, reqs, **kw):
    """Drive an engine to completion; returns (finished, seconds, decode
    steps)."""
    eng = engine_cls(model, params, batch_slots=SLOTS, max_seq=MAX_SEQ,
                     page_size=PAGE, prefill_chunk=CHUNK, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.queue or any(r is not None for r in eng.active):
        steps += eng.step() > 0
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    # the pool holds every slot's full row, so nothing is preempted and
    # each prompt is prefilled exactly once
    require(len(eng.finished) == len(reqs) and not eng.refused
            and not any(r.n_preempted for r in eng.finished),
            f"{engine_cls.__name__}: {len(eng.finished)} of {len(reqs)} "
            "requests finished without preemption")
    return eng.finished, dt, steps


def serve_stats(arch, n_params, fin, dt, launches, peak, resident):
    tokens = sum(len(r.out) for r in fin)
    ttft = [r.first_token_t - r.submit_t for r in fin]
    per_tok = [(r.finish_t - r.first_token_t) / (len(r.out) - 1)
               for r in fin]
    return dict(
        arch=arch, params=n_params, requests=len(fin), tokens=tokens,
        seconds=dt, tok_per_s=tokens / dt,
        ttft_p50_ms=1e3 * statistics.median(ttft),
        decode_ms_per_token_p50=1e3 * statistics.median(per_tok),
        resident_before_gib=resident / 2**30, peak_mem_gib=peak / 2**30,
        launches=launches)


def agree(got, want, what):
    """Logits (steps, V) of the card against a reference: max |diff|
    within LOGIT_TOL of the largest logit, and greedy tokens equal
    wherever the reference's top-1/top-2 margin exceeds twice that."""
    require(bool(torch.isfinite(got).all()), f"{what}: logits not finite")
    atol = LOGIT_TOL * float(want.abs().max())
    diff = float((got - want).abs().max())
    rel_rms = float((got - want).norm() / want.norm())
    top2 = torch.topk(want, 2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * atol
    same_sure = bool((got.argmax(-1)[sure] == want.argmax(-1)[sure]).all())
    same = int((got.argmax(-1) == want.argmax(-1)).sum())
    print(f"{what}: max abs diff {diff:.4g} = "
          f"{diff / float(want.abs().max()):.2%} of the largest logit "
          f"(tolerance {LOGIT_TOL:.0%}), relative rms {rel_rms:.3%}; greedy "
          f"tokens equal on {same}/{len(want)} steps, required on the "
          f"{int(sure.sum())} with a margin over {2 * atol:.3g}: {same_sure}")
    require(diff <= atol and same_sure, f"{what}: logits disagree")
    return dict(max_abs_diff_frac=diff / float(want.abs().max()),
                rel_rms=rel_rms, greedy_equal=same, steps=len(want))


def check_against_cpu(cfg, model, params):
    """A short prompt through prefill and 4 decode steps on the card and
    through the plain versions on the CPU, teacher-forced with the CPU's
    greedy tokens, held to :func:`agree`."""
    cpu = Model(cfg, device="cpu")
    cpu_params = {k: v.cpu() for k, v in params.items()}
    prompt = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (1, 64)).astype(np.int64)
    runs = []
    for m, p in ((model, params), (cpu, cpu_params)):
        cache = m.init_paged_cache(1, 128, PAGE)
        logits, cache = m.prefill_chunk_paged(
            p, cache, torch.from_numpy(prompt).to(m.device),
            cache["table"][0], 0)
        out = [logits[0, -1].float().cpu()]
        runs.append((m, p, cache, out))
    for s in range(4):
        tok = int(torch.argmax(runs[1][3][-1]))
        for m, p, cache, out in runs:
            logits, _ = m.decode_step_paged(
                p, cache, torch.tensor([[tok]], device=m.device),
                torch.tensor([64 + s], device=m.device))
            out.append(logits[0, 0].float().cpu())
    agree(torch.stack(runs[0][3]), torch.stack(runs[1][3]),
          "card vs cpu logits (qwen2, full width, 64-token prompt + 4 "
          "steps)")


def wall_and_device(step):
    """(eager wall ms, ended by a synchronize, median of 10; device ms of
    the same step replayed from a CUDA graph)."""
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(walls), cuda_ms([step], iters=5, warmup=1)


def step_breakdown(cfg, model, params):
    """One full decode step (8 slots, each at a serve-like position):
    host wall time of the eager step, ended by a synchronize, against the
    device time of the same step replayed from a CUDA graph.  Their gap
    is what the host adds per step."""
    cache = model.init_paged_cache(SLOTS, MAX_SEQ, PAGE)
    rng = np.random.default_rng(SEED + 2)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SLOTS, 1))).cuda()
    pos = torch.from_numpy(rng.integers(
        PROMPT_MIN, PROMPT_MAX + NEW_TOKENS, SLOTS)).cuda()

    wall, device = wall_and_device(
        lambda: model.decode_step_paged(params, cache, tokens, pos)[0])
    print(f"decode step (8 slots, full width): eager wall {wall:.3f} ms, "
          f"device (graph replay) {device:.3f} ms, device idle share of "
          f"the eager step {1 - device / wall:.1%}")
    return dict(decode_step_wall_ms=wall, decode_step_device_ms=device)


# ---------------------------------------------------------------------------
# phase 5: mamba2-780m through the dense-cache static engine
# ---------------------------------------------------------------------------

def mamba_gemm_cases(cfg):
    """(label, K, N, calls per decode step) of the mamba2 products; a
    prefill runs the same set at M = the prompt's length."""
    D, di, V, L = cfg.d_model, cfg.d_inner, cfg.padded_vocab, cfg.n_layers
    GN2 = 2 * cfg.ssm_groups * cfg.ssm_state
    return [("wx", D, di, L), ("wz", D, di, L), ("wbc", D, GN2, L),
            ("wdt", D, cfg.n_ssm_heads, L), ("w_out", di, D, L),
            ("unembed", D, V, 1)]


def check_mamba_gemm(cfg):
    """The GEMM kernel against its plain version at each mamba2 product's
    shape (``wdt``'s N = 48 is the one N of either model below a tile,
    ``w_out`` the one K = 3072), at M = 8 (a decode step) and at a ragged
    prefill M = PREFILL_M, each timed with L2-cold weights beside
    ``torch.matmul``.  Returns the sums over the 241 calls of a decode
    step and of a PREFILL_M-token prefill."""
    out = dict(gemm_ms=0.0, gemm_library_ms=0.0, gemm_bound_ms=0.0,
               prefill_gemm_ms=0.0, prefill_gemm_library_ms=0.0,
               prefill_gemm_bound_ms=0.0, gemm_max_abs_err=0.0)
    for M, key in ((SLOTS, "gemm"), (PREFILL_M, "prefill_gemm")):
        for i, (label, K, N, calls) in enumerate(mamba_gemm_cases(cfg)):
            n = copies(2 * K * N)
            a = randn((M, K), 1000 + i)
            bs = [randn((K, N), 1100 + i + 17 * j, 0.05) for j in range(n)]
            err = max_err(gemm_mod.matmul(a, bs[0], torch.float32),
                          ref.matmul(a, bs[0], torch.float32),
                          f"mamba2 gemm {label} M={M}")
            ms = cuda_ms([lambda b=b: gemm_mod.matmul(a, b, torch.float32)
                          for b in bs], iters=max(20, 4 * n))
            lib = cuda_ms([lambda b=b: torch.matmul(a, b) for b in bs],
                          iters=max(20, 4 * n))
            bms, _ = bound(2 * (M * K + K * N) + 4 * M * N, 2.0 * M * N * K)
            print(f"mamba2 gemm {label:7s} M={M} K={K} N={N} "
                  f"({plan_label(M, K, N)}): {ms:.4f} ms x {calls} (bound "
                  f"{bms:.4f} ms, torch.matmul {lib:.4f} ms), max abs err "
                  f"{err:.3g}")
            out[f"{key}_ms"] += calls * ms
            out[f"{key}_library_ms"] += calls * lib
            out[f"{key}_bound_ms"] += calls * bms
            out["gemm_max_abs_err"] = max(out["gemm_max_abs_err"], err)
    return out


def mamba_step_breakdown(cfg, model, params):
    """One decode step of 8 slots: eager wall time (ended by a
    synchronize), device time (the same step replayed from a CUDA graph),
    the GEMM kernel's share (:func:`check_mamba_gemm`), and the share of
    the plain ``ssd_step`` with the two rolling convolutions (48 layers'
    worth replayed from a graph on the cache's own state rows)."""
    cache = model.init_cache(SLOTS, MAX_SEQ)
    rng = np.random.default_rng(SEED + 3)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SLOTS, 1))).cuda()
    pos = torch.from_numpy(rng.integers(
        PROMPT_MIN, PROMPT_MAX + NEW_TOKENS, SLOTS)).cuda()

    wall, device = wall_and_device(
        lambda: model.decode_step(params, cache, tokens, pos)[0])
    gemm = check_mamba_gemm(cfg)

    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di, GN2 = cfg.d_inner, 2 * cfg.ssm_groups * cfg.ssm_state
    g = gen(1200)
    xz = torch.randn((SLOTS, 1, di), generator=g, device="cuda")
    bc = torch.randn((SLOTS, 1, GN2), generator=g, device="cuda")
    dt = torch.rand((SLOTS, H), generator=g, device="cuda") * 0.1
    A = -(1.0 + 15.0 * torch.rand(H, generator=g, device="cuda"))
    lp = [model._layer(params, i)["ssm"] for i in range(cfg.n_layers)]

    def mixer_plain():
        for i, p in enumerate(lp):
            x1, _ = ssm._causal_conv(xz, p["conv_x"].float(),
                                     cache["conv"][i])
            b1, _ = ssm._causal_conv(bc, p["conv_bc"].float(),
                                     cache["bc_conv"][i])
            b1 = torch.nn.functional.silu(b1)
            ops.ssd_step(torch.nn.functional.silu(x1).reshape(SLOTS, H, P),
                         dt, A, b1[:, 0, :GN2 // 2].reshape(SLOTS, 1, N),
                         b1[:, 0, GN2 // 2:].reshape(SLOTS, 1, N),
                         cache["ssm"][i])

    mixer = cuda_ms([mixer_plain], iters=3, warmup=1)
    out = dict(decode_step_wall_ms=wall, decode_step_device_ms=device,
               **gemm, ssd_step_and_conv_ms=mixer,
               other_device_ms=device - gemm["gemm_ms"] - mixer,
               host_ms=wall - device)
    print("mamba2 decode step (8 slots, full width): " + ", ".join(
        f"{k} {v:.4g}" for k, v in out.items())
        + f"; device idle share of the eager step {1 - device / wall:.1%}")
    return out


def state_drift(got, want):
    """Per cache key: (max |diff| of layer 0 over its largest magnitude,
    each layer's relative RMS)."""
    out = {}
    for k in ("conv", "ssm", "bc_conv"):
        g, w = got[k].float().cpu(), want[k].float().cpu()
        d = g - w
        out[k] = (float(d[0].abs().max() / w[0].abs().max()),
                  [float(d[i].norm() / w[i].norm())
                   for i in range(w.shape[0])])
    return out


def states_agree(drift, keys=("conv", "ssm", "bc_conv")) -> bool:
    return all(drift[k][0] <= STATE_TOL for k in keys)


def check_mamba_against_cpu(cfg, model, params):
    """A 64-token prompt through prefill and 4 decode steps on the card
    and through the plain versions on the CPU, on the engine's path (the
    prefill's states written into a row of a dense cache).  The first
    layer's prefill states are held to :func:`states_agree` (every
    layer's relative RMS is printed); two controls on the card must fail
    it on the SSM state, so the check can see the scan: the
    state zeroed, and the state of the prompt with its last token changed.
    The logits, teacher-forced with the CPU's greedy tokens, are held to
    :func:`agree`."""
    cpu = Model(cfg, device="cpu")
    cpu_params = {k: v.cpu() for k, v in params.items()}
    prompt = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (1, 64)).astype(np.int64))
    runs = []
    for m, p in ((model, params), (cpu, cpu_params)):
        logits, cache = m.prefill(p, prompt.to(m.device),
                                  cache=m.init_cache(1, 128), slot=0)
        runs.append((m, p, cache, [logits[0, -1].float().cpu()]))
    card, want = runs[0][2], runs[1][2]
    zeroed = dict(card, ssm=torch.zeros_like(card["ssm"]))
    other = prompt.clone()
    other[0, -1] = (other[0, -1] + 1) % cfg.vocab_size
    _, changed = model.prefill(params, other.cuda(),
                               cache=model.init_cache(1, 128), slot=0)
    out = {}
    for what, got in (("card", card), ("control: zeroed ssm state", zeroed),
                      ("control: last prompt token changed", changed)):
        drift = state_drift(got, want)
        out[what] = drift
        print(f"mamba2 prefill states, {what} vs cpu: layer 0 max abs diff "
              f"of the largest magnitude (tolerance {STATE_TOL:g}) "
              + ", ".join(f"{k} {l0:.3g}" for k, (l0, _) in drift.items())
              + "; worst layer's relative rms " + ", ".join(
                  f"{k} {max(r):.3g} (layer {r.index(max(r))})"
                  for k, (_, r) in drift.items()))
        print("  ssm relative rms by layer: "
              + " ".join(f"{r:.3g}" for r in drift["ssm"][1]))
        if what == "card":
            require(states_agree(drift), "mamba2 prefill states on the card "
                    "disagree with the CPU's")
        else:
            require(not states_agree(drift, ("ssm",)),
                    f"mamba2 state check cannot see a wrong scan ({what} "
                    "passes it)")
    for s in range(4):
        tok = int(torch.argmax(runs[1][3][-1]))
        for m, p, cache, logits_out in runs:
            logits, _ = m.decode_step(
                p, cache, torch.tensor([[tok]], device=m.device),
                torch.tensor([64 + s], device=m.device))
            logits_out.append(logits[0, 0].float().cpu())
    out["logits"] = agree(torch.stack(runs[0][3]), torch.stack(runs[1][3]),
                          "card vs cpu logits (mamba2, full width, 64-token "
                          "prompt + 4 steps)")
    return out


def check_prefill_then_decode(cfg, model, params, S=300):
    """Prefill S-1 tokens (the SSD kernel's final state, ragged against
    its chunk), decode position S-1 with the plain ``ssd_step``
    recurrence, and compare with the full forward on S tokens, on the
    card: the logits of the last position (:func:`agree`), and the cache
    after the step against the forward's states after S tokens, within
    STATE_TOL of each state's largest magnitude.  With random weights the
    SSM state moves the logits little (the D skip dominates), so the
    states are compared directly; a control decodes from a zeroed state,
    and its SSM state must fail the comparison."""
    toks = torch.from_numpy(np.random.default_rng(SEED + 4).integers(
        0, cfg.vocab_size, (1, S))).cuda()
    full, _, states = model.forward(params, toks, with_cache=True)
    want = full[:, -1].float().cpu()
    _, cache = model.prefill(params, toks[:, :-1])
    control = {k: v.clone() for k, v in cache.items()}
    control["ssm"].zero_()
    pos = torch.tensor([S - 1], device="cuda")
    got, _ = model.decode_step(params, cache, toks[:, -1:], pos)
    out = agree(got[:, 0].float().cpu(), want,
                f"mamba2 prefill {S - 1} + decode vs forward {S} (card)")
    for k, ref_state in zip(("conv", "ssm", "bc_conv"), states):
        d = float((cache[k].float() - ref_state.float()).abs().max()
                  / ref_state.float().abs().max())
        out[f"{k}_diff_frac"] = d
        print(f"  {k} state after the step vs the forward's: max abs diff "
              f"{d:.3g} of its largest magnitude (tolerance {STATE_TOL:g})")
        require(d <= STATE_TOL, f"mamba2 {k} state after prefill + decode "
                "disagrees with the forward's")
    lost, _ = model.decode_step(params, control, toks[:, -1:], pos)
    out["zeroed_state_diff_frac"] = float(
        (lost[:, 0].float().cpu() - want).abs().max() / want.abs().max())
    d = float((control["ssm"].float() - states[1].float()).abs().max()
              / states[1].float().abs().max())
    print(f"  control: decoding from a zeroed SSM state moves the logits by "
          f"{out['zeroed_state_diff_frac']:.2%} of the largest and the ssm "
          f"state by {d:.3g} of its largest magnitude")
    require(d > STATE_TOL, "the state comparison cannot see a lost state")
    return out


def serve_mamba():
    """mamba2-780m at full width through ``Engine(paged=False)``; returns
    (the serve stats, the launch counts)."""
    cfg = get_config(MAMBA)
    model = Model(cfg, device="cuda")
    params = model.init(SEED)
    n_params = sum(p.numel() for p in params.values())
    require(n_params == MAMBA_PARAMS and cfg.n_layers == 48,
            f"mamba2: {n_params} parameters in {cfg.n_layers} layers")
    serve(Engine, model, params, requests(cfg)[:2])             # warm-up
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    fin, dt, steps = serve(Engine, model, params, requests(cfg))
    launches = ops.dispatch_report()
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    prefills = len(fin)
    expect = {"matmul": (5 * L + 1) * (prefills + steps), "attention": 0,
              "attention_backward": 0, "paged_decode_attention": 0,
              "ssd": L * prefills, "quantize_int8": 0, "quantize_compress": 0,
              "matmul_dequant": 0}
    print(f"mamba2 launches: {launches} (expected {expect}: {steps} decode "
          f"steps, {prefills} prefills)")
    require(launches["matmul"] > 0 and launches["ssd"] > 0,
            "a kernel of the mamba2 serve path was never launched")
    require(launches == expect,
            "mamba2 launch counts do not match the layer loop")
    stats = serve_stats(MAMBA, n_params, fin, dt, launches, peak, resident)
    stats.update(decode_steps=steps, prefills=prefills,
                 **mamba_step_breakdown(cfg, model, params))
    print("serve " + json.dumps(stats), flush=True)
    stats["card_vs_cpu"] = check_mamba_against_cpu(cfg, model, params)
    stats["prefill_decode_vs_forward"] = check_prefill_then_decode(
        cfg, model, params)
    return stats, launches


# ---------------------------------------------------------------------------
# phase 6: train qwen2-0.5b at full width, two ranks on the card
# ---------------------------------------------------------------------------

# The int8 wire's nine gradient buckets at qwen2-0.5b (the reference's
# plan at 32 MiB; tests/test_torch_comms.py pins it).
BUCKETS = (136_134_656, 2_781_056, 19_267_584, 19_267_584, 2_795_520,
           104_595_456, 104_595_456, 104_595_456, 136_134_656)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, RANKS = 4, 512, 6, 2
# AdamW moves every weight by about lr from the first step on: a peak of
# 1e-4 keeps six steps from overshooting (the loss falls on the batches
# seen and on the first one seen again) while most bf16 weights of
# magnitude <= 0.05 still change at step 1.
TRAIN_PEAK, TRAIN_WARMUP = 1e-4, 2
PROFILED = TRAIN_STEPS - 2          # the int8 step traced by the profiler
TRAIN_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"
# bf16 gradients, card against plain: the kernels' products round their
# operands (O, dO, the cotangent) to bf16 where the plain versions keep
# fp32, and sums run in another order (tests/test_torch_kernels.py).
GRAD_RTOL, GRAD_ATOL_FRAC = 3e-2, 2e-2
# Card against CPU, 2 layers: every GEMM's sum order differs and the
# kernels round at other places, which moves the logits by ~0.3% of the
# largest at 2 layers (phase 4's check); the CPU port agrees with the
# reference's gradients to 0.5% relative rms at 2 layers
# (tests/test_torch_train.py).  Ten times that per leaf: 5% relative rms
# and 5% of the leaf's largest value; loss rtol 1e-3, grad norm 2e-2.
CPU_GRAD_TOL, CPU_LOSS_RTOL, CPU_NORM_RTOL = 5e-2, 1e-3, 2e-2


def train_adamw():
    from repro_torch.train import optimizer as opt
    return opt.AdamWConfig(lr=opt.warmup_cosine(TRAIN_PEAK, TRAIN_WARMUP,
                                                 TRAIN_STEPS))


def train_batches(cfg):
    from repro_torch.data import SyntheticLM
    data = iter(SyntheticLM(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                            seed=SEED, structured=True))
    return [next(data) for _ in range(TRAIN_STEPS)]


def expected_train_launches(cfg, steps: int, int8: bool):
    """Per rank.  Each layer runs 7 products and one attention forward;
    ``remat="full"`` runs every layer's forward again in the backward;
    each product's backward runs two products (dA, dB), each attention
    one backward kernel; the head's unembed is not checkpointed; the int8
    wire quantizes each of its buckets once."""
    L = cfg.n_layers
    fwd = 7 * L + 1
    return {"matmul": steps * (fwd + 7 * L + 2 * fwd),
            "attention": steps * 2 * L,
            "attention_backward": steps * L,
            "paged_decode_attention": 0, "ssd": 0,
            "quantize_int8": steps * (len(BUCKETS) if int8 else 0),
            "quantize_compress": 0, "matmul_dequant": 0}


def event_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    """Device ms per eager call (CUDA events around ``iters`` calls): for
    the plain and library versions that run autograd, which a CUDA graph
    does not capture."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_quantize():
    """``quantize_int8`` against its plain version, bitwise, at each of
    the wire's bucket lengths (timed), a ragged length, exact .5 ties and
    a zero bucket."""
    from repro_torch.kernels import fused as fused_mod
    step = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    print("quantize_int8: n | kernel ms | bound ms (by) | plain ms | "
          "bitwise equal")
    g = gen(1300)
    cases = [(f"bucket {i}", n) for i, n in enumerate(BUCKETS)]
    cases += [("ragged", 4096 * 37 + 3), ("ties", 100_003), ("zero", 4097)]
    timed = {}
    for label, n in cases:
        x = torch.randn(n, generator=g, device="cuda") * 1e-3
        if label == "zero":
            x.zero_()
        scale = ref.int8_scale(x.abs().max())
        if label == "ties":
            scale = torch.full((), 2.0 ** -10, device="cuda")
            k = torch.randint(-127, 127, (n,), generator=g,
                              device="cuda").float() + 0.5
            x = torch.where(torch.arange(n, device="cuda") % 2 == 0,
                            k * scale, x)
        got = fused_mod.quantize_int8(x, scale)
        same = torch.equal(got, ref.quantize_int8(x, scale))
        require(same, f"quantize_int8 {label} (n={n}) is not bitwise its "
                "plain version")
        if label == "zero":
            require(not bool(got.any()), "a zero bucket quantizes to zero")
        bms, by = bound(5.0 * n, 3.0 * n, FP32_FLOPS)
        if label.startswith("bucket"):
            if n not in timed:
                timed[n] = (
                    cuda_ms([lambda: fused_mod.quantize_int8(x, scale)],
                            iters=20),
                    event_ms(lambda: ref.quantize_int8(x, scale), iters=3))
            ms, plain = timed[n]
            for key, val in (("ms", ms), ("plain_ms", plain),
                             ("bound_ms", bms)):
                step[key] += val
            print(f"quantize_int8 {label} {n} | {ms:.4f} | {bms:.4f} ({by})"
                  f" | {plain:.4f} | {same}")
        else:
            print(f"quantize_int8 {label} {n} | - | {bms:.4f} ({by}) | - | "
                  f"{same}")
    print(f"quantize_int8: one step's 9 buckets per rank: {step['ms']:.4f} "
          f"ms, bound {step['bound_ms']:.4f} ms (bytes), plain "
          f"{step['plain_ms']:.4f} ms")
    return dict(name="quantize_int8", route="cuda",
                source="src/repro_torch/kernels/csrc/quantize.cu",
                replaces="src/repro/kernels/fused.py:117",
                case="one train step's 9 gradient buckets of one rank "
                     f"({sum(BUCKETS)} fp32 elements)",
                max_abs_err=0.0, bound_by="bytes", library_ms=None, **step)


def leaf_lengths(cfg):
    """(name, elements) of qwen2-0.5b's 15 parameter leaves, in the
    params' order: the compressed step quantizes each once per int8
    step."""
    specs = Model(cfg, device="cpu").param_specs()
    return [(name, math.prod(spec.shape)) for name, spec in specs.items()]


def compress_input(label, n, g):
    """An input of ``quantize_compress``: fp32 gradient-like values, or
    bf16 ones; ``zero`` all zeros (scale fl32(1e-12), q 0); ``ties`` the
    largest magnitude 127 * 2^-10 (scale exactly 2^-10) and every other
    element an exact .5 multiple of the scale; ``negative`` the largest
    magnitude on a negative element."""
    x = torch.randn(n, generator=g, device="cuda") * 1e-3
    if label == "zero":
        x.zero_()
    if label == "ties":
        k = torch.randint(-127, 127, (n,), generator=g,
                          device="cuda").float() + 0.5
        x = torch.where(torch.arange(n, device="cuda") % 2 == 0,
                        k * 2.0 ** -10, x * 0.1)
        x[n // 2] = 127 * 2.0 ** -10
        require(float(ref.int8_scale(x.abs().max())) == 2.0 ** -10,
                "the ties case's scale is not 2^-10")
    if label == "negative":
        x[n // 3] = -2 * x.abs().max()
    return x.to(torch.bfloat16) if label == "bf16" else x


def check_quantize_compress(cfg):
    """``quantize_compress`` against its plain version, bitwise in q and
    the scale, at each of qwen2-0.5b's 15 leaf lengths (timed: one int8
    step of the compressed SGD path on one rank), ragged lengths, a bf16
    input, an all-zero input, exact .5 ties and a negative absmax.  The
    bound reads the input once and writes int8 (5 bytes per fp32
    element); the kernel reads it twice (9 bytes), which is printed as
    its two-pass floor."""
    from repro_torch.kernels import fused as fused_mod
    step = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, two_pass_bound_ms=0.0)
    print("quantize_compress: leaf n | kernel ms | bound ms (by) | two-pass "
          "ms | plain ms | bitwise equal")
    g = gen(1700)
    leaves = dict(leaf_lengths(cfg))
    cases = list(leaves.items())
    cases += [("ragged", 4096 * 37 + 3), ("bf16", 1_000_003),
              ("zero", 4097), ("ties", 100_003), ("negative", 999_999),
              ("one", 1)]
    timed = {}
    for label, n in cases:
        x = compress_input(label, n, g)
        q, s = fused_mod.quantize_compress(x)
        qw, sw = ref.quantize_compress(x)
        same = torch.equal(q, qw) and torch.equal(s, sw)
        require(same, f"quantize_compress {label} (n={n}) is not bitwise "
                "its plain version")
        if label == "zero":
            require(not bool(q.any()) and float(s) == float(
                np.float32(1e-12)), "a zero input gives q 0, scale 1e-12")
        elt = x.element_size()
        bms, by = bound((elt + 1.0) * n + 4, 6.0 * n, FP32_FLOPS)
        two_pass = (2 * elt + 1.0) * n / HBM_BYTES_PER_S * 1e3
        if label in leaves:
            if n not in timed:
                timed[n] = (
                    cuda_ms([lambda: fused_mod.quantize_compress(x)],
                            iters=20),
                    event_ms(lambda: ref.quantize_compress(x), iters=3))
            ms, plain = timed[n]
            for key, val in (("ms", ms), ("plain_ms", plain),
                             ("bound_ms", bms),
                             ("two_pass_bound_ms", two_pass)):
                step[key] += val
            print(f"quantize_compress {label} {n} | {ms:.4f} | {bms:.4f} "
                  f"({by}) | {two_pass:.4f} | {plain:.4f} | {same}")
        else:
            print(f"quantize_compress {label} {n} | - | {bms:.4f} ({by}) | "
                  f"- | - | {same}")
    n_all = sum(leaves.values())
    print(f"quantize_compress: one int8 step's 15 leaves per rank "
          f"({n_all} elements): {step['ms']:.4f} ms, bound "
          f"{step['bound_ms']:.4f} ms (bytes), two-pass floor "
          f"{step['two_pass_bound_ms']:.4f} ms, plain "
          f"{step['plain_ms']:.4f} ms")
    return dict(name="quantize_compress", route="cuda",
                source="src/repro_torch/kernels/csrc/quantize.cu",
                replaces="src/repro/kernels/fused.py:77",
                case="one int8 step of the compressed SGD path on one rank: "
                     f"qwen2-0.5b's 15 leaves ({n_all} fp32 elements)",
                max_abs_err=0.0, bound_by="bytes", library_ms=None, **step)


# the reference's matmul_dequant tolerances (tests/test_fused_kernels.py)
DEQUANT_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-2, 2e-2)}


def check_matmul_dequant(cfg):
    """``matmul_dequant`` against its plain version at qwen2-0.5b's eight
    decode products (M = 8) and at a prefill M = 128, at the bench shape
    (8, 1024, 1024) and the reference test's ragged shapes, for bf16 and
    fp32 activations, at the reference's tolerances; timed beside its
    bound, its plain version and ``torch.matmul`` on the already-widened
    weights (a yardstick only: no library call computes the dequant
    product).  Weights: normal * 0.05, quantized per column."""
    shapes = [(M, label, K, N, calls) for M in (SLOTS, CHUNK)
              for label, K, N, calls in gemm_cases(cfg)]
    shapes += [(8, "bench", 1024, 1024, 0), (5, "ragged", 300, 77, 0),
               (130, "ragged", 257, 129, 0)]
    rows = {dt: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                     bytes=0.0, flops=0.0) for dt in DEQUANT_TOL}
    errs = {dt: 0.0 for dt in DEQUANT_TOL}
    print("matmul_dequant: dtype label M K N | kernel ms | bound ms (by) | "
          "plain ms | torch.matmul (widened B) ms | max abs err")
    for i, (M, label, K, N, calls) in enumerate(shapes):
        n = copies(K * N)
        ws = [torch.randn((K, N), generator=gen(1800 + 7 * i + j),
                          device="cuda") * 0.05 for j in range(n)]
        qs = [ops.quantize_int8_per_channel(w) for w in ws]
        del ws
        for dt, (rtol, atol) in DEQUANT_TOL.items():
            a = torch.randn((M, K), generator=gen(1900 + i),
                            device="cuda").to(dt)
            bq, bs = qs[0]
            got = gemm_mod.matmul_dequant(a, bq, bs, torch.float32)
            want = ref.matmul_dequant(a, bq, bs, torch.float32)
            require(bool(torch.isfinite(got).all()),
                    f"matmul_dequant {label}: non-finite output")
            e = (got - want).abs()
            require(not bool((e > atol + rtol * want.abs()).any()),
                    f"matmul_dequant {dt} {label} ({M},{K},{N}) disagrees "
                    f"with its plain version (max abs err "
                    f"{float(e.max()):.3g}, tolerance {atol} + {rtol} |ref|)")
            errs[dt] = max(errs[dt], float(e.max()))
            if label == "ragged":
                print(f"matmul_dequant {dt} {label} {M} {K} {N} | - | - | - "
                      f"| - | {float(e.max()):.3g}")
                continue
            wide = [q.to(dt) for q, _ in qs[:2]]
            ms = cuda_ms([lambda q=q, s=s: gemm_mod.matmul_dequant(
                a, q, s, torch.float32) for q, s in qs], iters=max(20, 4 * n))
            plain = cuda_ms([lambda q=q, s=s: ref.matmul_dequant(
                a, q, s, torch.float32) for q, s in qs[:2]], iters=5,
                warmup=1)
            lib = cuda_ms([lambda b=b: torch.matmul(a, b) for b in wide],
                          iters=max(20, 4 * n))
            nbytes = a.element_size() * M * K + K * N + 4 * N + 4 * M * N
            flops = 2.0 * M * N * K
            bms, by = bound(nbytes, flops, BF16_FLOPS if dt == torch.bfloat16
                            else FP32_FLOPS)
            print(f"matmul_dequant {dt} {label:7s} {M:4d} {K:5d} {N:6d} | "
                  f"{ms:.4f} | {bms:.4f} ({by}) | {plain:.4f} | {lib:.4f} | "
                  f"{float(e.max()):.3g}")
            if M == SLOTS and calls:
                for key, val in (("ms", ms), ("plain_ms", plain),
                                 ("library_ms", lib), ("bound_ms", bms),
                                 ("bytes", nbytes), ("flops", flops)):
                    rows[dt][key] += calls * val
    out = {}
    for dt, r in rows.items():
        bms, by = bound(r["bytes"], r["flops"], BF16_FLOPS
                        if dt == torch.bfloat16 else FP32_FLOPS)
        out[dt] = dict(r, bound_ms=bms, bound_by=by)
        print(f"matmul_dequant {dt}: one qwen2-0.5b decode step's 169 "
              f"products at M={SLOTS}: {r['ms']:.4f} ms, bound {bms:.4f} ms "
              f"({by}), plain {r['plain_ms']:.4f} ms, torch.matmul on "
              f"widened weights {r['library_ms']:.4f} ms")
    bf, f32 = out[torch.bfloat16], out[torch.float32]
    return dict(name="matmul_dequant", route="cuda",
                source="src/repro_torch/kernels/csrc/gemm_dequant.cu",
                replaces="src/repro/kernels/gemm.py:115",
                case=f"one qwen2-0.5b decode step's 169 products at M={SLOTS}"
                     ", bf16 activations, int8 weights (no model path calls "
                     "it: entry point ops.matmul_dequant only)",
                max_abs_err=errs[torch.bfloat16], ms=bf["ms"],
                plain_ms=bf["plain_ms"], bound_ms=bf["bound_ms"],
                bound_by=bf["bound_by"], library_ms=bf["library_ms"],
                library="torch.matmul on the weights widened to bf16 "
                        "beforehand (timed only)",
                fp32_activations=dict(
                    ms=f32["ms"], plain_ms=f32["plain_ms"],
                    bound_ms=f32["bound_ms"], bound_by=f32["bound_by"],
                    library_ms=f32["library_ms"],
                    max_abs_err=errs[torch.float32]))


def bwd_inputs(seed, B, hq, hkv, S, T, D=64):
    return (randn((B, hq, S, D), seed), randn((B, hkv, T, D), seed + 1),
            randn((B, hkv, T, D), seed + 2), randn((B, hq, S, D), seed + 3))


def grads_close(got, want, what):
    err = 0.0
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        g, w = g.float(), w.float()
        require(bool(torch.isfinite(g).all()), f"{what} {name}: not finite")
        atol = GRAD_ATOL_FRAC * float(w.abs().max()) + 1e-6
        e = (g - w).abs()
        require(not bool((e > atol + GRAD_RTOL * w.abs()).any()),
                f"{what} {name}: kernel disagrees with its plain version "
                f"(max abs err {float(e.max()):.3g}, tolerance {atol:.3g} + "
                f"{GRAD_RTOL} |ref|)")
        err = max(err, float(e.max()))
    return err


def kernel_us(fn, calls: int = 10):
    """Device µs per call of ``fn`` in each kernel it launches, by the
    kernel's name (the profiler's sums over ``calls`` eager calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = re.search(r"(\w+)_kernel\b", e.key)
        if "CUDA" in str(e.device_type) and name \
                and e.self_device_time_total > 0:
            out[name.group(1)] = (out.get(name.group(1), 0.0)
                                  + e.self_device_time_total / calls)
    return out


def check_attention_backward(cfg):
    """The backward kernel against autograd through the plain attention
    at the train shape and at small ragged, window and softcap shapes,
    zero gradients on rows with no visible key; timed at the train shape
    beside one ``torch.autograd.grad`` through SDPA (timed only), with
    the forward that keeps its log-sum-exp beside its bound and SDPA's
    forward (``is_causal=True, enable_gqa=True``; timed only)."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    B = TRAIN_BATCH // RANKS
    cases = [("train", B, H, Hkv, TRAIN_SEQ, TRAIN_SEQ, 0, None, None),
             ("ragged", 1, 4, 2, 37, 100, 63, None, None),
             ("window", 2, 6, 3, 96, 96, 0, 24, None),
             ("softcap", 1, 4, 1, 64, 64, 0, None, 5.0),
             ("no visible key", 1, 2, 1, 16, 40, 20, 1, None)]
    errs, row = [], None
    print("attention backward: case | kernel ms | bound ms (by) | plain ms"
          " | sdpa backward ms | max abs err")
    for i, (label, b, hq, hkv, S, T, off, window, cap) in enumerate(cases):
        q, k, v, do = bwd_inputs(1400 + 10 * i, b, hq, hkv, S, T, hd)
        kw = dict(causal=True, window=window, softcap=cap, q_offset=off)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        got = torch.autograd.grad(fa_mod.attention(*leaves, **kw), leaves,
                                  do)
        want = ref.attention_backward(q, k, v, do, **kw)
        err = grads_close(got, want, f"attention backward {label}")
        errs.append(err)
        if window == 1:
            require(not bool(got[0][:, :, 20:].any()),
                    "rows with no visible key must get zero gradients")
        if label != "train":
            print(f"attention backward {label:15s} | - | - | - | - | "
                  f"{err:.3g}")
            continue
        n = copies(2 * (3 * q.numel() + 2 * k.numel()))
        sets = [bwd_inputs(1500 + 4 * j, b, hq, hkv, S, T, hd)
                for j in range(n)]
        outs = [fa_mod._forward(*s[:3], True, None, None, hd ** -0.5, 0,
                                with_lse=True) for s in sets]
        ms = cuda_ms([lambda s=s, o=o: fa_mod.attention_backward(
            *s[:3], o[0], s[3], o[1]) for s, o in zip(sets, outs)],
            iters=max(10, 2 * n))
        fwd = cuda_ms([lambda s=s: fa_mod._forward(
            *s[:3], True, None, None, hd ** -0.5, 0, with_lse=True)
            for s in sets], iters=max(10, 2 * n))
        fwd_lib = cuda_ms([lambda s=s: torch.nn.functional
                           .scaled_dot_product_attention(
                               *s[:3], is_causal=True, enable_gqa=True)
                           for s in sets], iters=max(10, 2 * n))
        plain = event_ms(lambda: ref.attention_backward(q, k, v, do, **kw))

        def sdpa():
            ls = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o = torch.nn.functional.scaled_dot_product_attention(
                *ls, is_causal=True, enable_gqa=True)
            return torch.autograd.grad(o, ls, do)
        lib = event_ms(sdpa, iters=10, warmup=2)
        split = kernel_us(lambda: fa_mod.attention_backward(
            *sets[0][:3], outs[0][0], sets[0][3], outs[0][1]))
        print("attention backward kernels, device µs per call: "
              + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
        pairs = S * (S + 1) // 2
        # recompute QK^T and dP (2 products), dV, dK, dQ (3): 5 products
        flops = 5 * 2.0 * b * hq * pairs * hd
        nbytes = 2 * (3 * q.numel() + 4 * k.numel()) + 4 * b * hq * S
        bms, by = bound(nbytes, flops)
        # the forward with its log-sum-exp: q, k, v read, out and lse
        # written; QK^T and PV over the causal pairs
        fbms, fby = bound(
            2 * (2 * q.numel() + 2 * k.numel()) + 4 * b * hq * S,
            2 * 2.0 * b * hq * pairs * hd)
        print(f"attention backward {label:15s} | {ms:.4f} | {bms:.4f} ({by})"
              f" | {plain:.4f} | {lib:.4f} | {err:.3g}; the forward with "
              f"its log-sum-exp {fwd:.4f} ms, bound {fbms:.5f} ({fby}), "
              f"sdpa forward {fwd_lib:.4f} ms")
        row = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                   bound_by=by, forward_with_lse_ms=fwd,
                   forward_bound_ms=fbms, forward_bound_by=fby,
                   forward_library_ms=fwd_lib, kernels_us=split,
                   case=f"one layer's backward on one rank: q ({b},{hq},{S},"
                        f"{hd}), k/v ({b},{hkv},{T},{hd}), causal")
    return dict(name="attention_backward", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                replaces="src/repro/models/layers.py:52",
                note="no TPU kernel: the reference trains through "
                     "layers.flash_attention_jnp's autodiff",
                max_abs_err=max(errs), **row)


def check_gemm_backward(cfg):
    """dA = dC Bᵀ and dB = Aᵀ dC on the GEMM kernel against the plain
    products at every train shape (M = one rank's 1,024 tokens), timed
    with the forward product; the backward products are timed as the
    backward calls them, on transposed views of A and B (the kernel reads
    either layout; no copy is made), with their plans; returns the
    kernel's ms per train step per rank (the forward, its recompute under
    remat, the backward)."""
    M = TRAIN_BATCH // RANKS * TRAIN_SEQ
    L = cfg.n_layers
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               fwd_ms=0.0, bwd_ms=0.0)
    errs = []
    print("gemm train products: label M K N | fwd ms | dA ms | dB ms | "
          "bound ms | plain ms | torch.matmul ms | max abs err")
    for i, (label, K, N, _) in enumerate(gemm_cases(cfg)):
        calls = 1 if label == "unembed" else L
        a, b = randn((M, K), 1600 + i), randn((K, N), 1620 + i, 0.05)
        dc = randn((M, N), 1640 + i)
        leaves = [a.clone().requires_grad_(True),
                  b.clone().requires_grad_(True)]
        got = torch.autograd.grad(
            gemm_mod.matmul(*leaves, torch.float32), leaves, dc.float())
        # the backward passes Bᵀ and Aᵀ as transposed views: no copies
        bt, at = b.t(), a.t()
        want = (ref.matmul(dc, bt, torch.bfloat16),
                ref.matmul(at, dc, torch.bfloat16))
        err = 0.0
        for g_, w_, nm in zip(got, want, ("dA", "dB")):
            e = (g_.float() - w_.float()).abs()
            tol = GRAD_ATOL_FRAC * float(w_.float().abs().max())
            require(not bool((e > tol + GRAD_RTOL * w_.float().abs()).any()),
                    f"gemm backward {label} {nm} disagrees with its plain "
                    f"version (max abs err {float(e.max()):.3g})")
            err = max(err, float(e.max()))
        errs.append(err)
        prods = ((a, b, torch.float32), (dc, bt, torch.bfloat16),
                 (at, dc, torch.bfloat16))
        ms = [cuda_ms([lambda x=x, y=y, o=o: gemm_mod.matmul(x, y, o)],
                      iters=10) for x, y, o in prods]
        plain = [event_ms(lambda x=x, y=y, o=o: ref.matmul(x, y, o),
                          iters=3) for x, y, o in prods]
        lib = [cuda_ms([lambda x=x, y=y: torch.matmul(x, y)], iters=10)
               for x, y, _ in prods]
        flops = 2.0 * M * N * K
        bms = [bound(2 * (x.numel() + y.numel()) + x.shape[0] * y.shape[1]
                     * (4 if o == torch.float32 else 2), flops)[0]
               for x, y, o in prods]
        print(f"gemm train {label:7s} {M} {K} {N} | {ms[0]:.4f} | "
              f"{ms[1]:.4f} | {ms[2]:.4f} | {sum(bms):.4f} | "
              f"{sum(plain):.4f} | {sum(lib):.4f} | {err:.3g} | plans: "
              f"{plan_label(M, K, N)}; dA {plan_label(M, N, K)}; dB "
              f"{plan_label(K, M, N, a_transposed=True)}")
        # per step: the forward, its recompute under remat (not the
        # head's), and the two backward products
        n = (calls * (1 if label == "unembed" else 2), calls, calls)
        tot["fwd_ms"] += n[0] * ms[0]
        tot["bwd_ms"] += calls * (ms[1] + ms[2])
        for key, vals in (("ms", ms), ("plain_ms", plain),
                          ("library_ms", lib), ("bound_ms", bms)):
            tot[key] += sum(c * v for c, v in zip(n, vals))
    print("gemm: one train step per rank: " + ", ".join(
        f"{k} {v:.3f}" for k, v in tot.items()))
    return dict(max_abs_err=max(errs), **{f"train_step_{k}": v
                                          for k, v in tot.items()})


def params_digest(params) -> torch.Tensor:
    """A position-weighted int64 sum of every leaf's bits, per leaf, on
    the CPU: equal on two ranks iff (but for a 2^-64 chance) the leaves
    are bitwise equal."""
    out = []
    for name in sorted(params):
        bits = params[name].detach().reshape(-1).view(torch.int16)
        h = torch.zeros((), dtype=torch.int64, device=bits.device)
        for s in range(0, bits.numel(), 1 << 24):
            chunk = bits[s:s + (1 << 24)].to(torch.int64)
            idx = torch.arange(s, s + chunk.numel(), device=bits.device)
            h += (chunk * (idx * 2654435761 % 2147483629 + 1)).sum()
        out.append(h)
    return torch.stack(out).cpu()


def same_on_every_rank(digest: torch.Tensor) -> bool:
    import torch.distributed as dist
    hi, lo = digest.clone(), digest.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return torch.equal(hi, lo)


@torch.no_grad()
def step_agreement(got, want, p0, lr, what, quantized=False):
    """The step tolerance of tests/test_torch_train.py, on the card: at
    step 1 AdamW moves every weight by about lr whatever its gradient's
    size, so every weight lies within 2 lr (+20%, + one bf16 ulp) of the
    other run's; an element moved the other way by more than half an lr
    is rare (under 0.5% of the model), and the updates differ by under 10%
    of their rms.  On the int8 wire a weight whose synced gradient rounds
    to zero moves by its decay only, within lr of the fp32 result: the
    same bound holds, the moves under half an lr are not counted, and the
    rms rule does not apply."""
    worst = against = still = total = 0.0
    dd = uu = 0.0
    for name in got:
        g, w, p = got[name].float(), want[name].float(), p0[name].float()
        d = (g - w).abs()
        worst = max(worst, float((d - w.abs() * 2.0 ** -7).max()))
        ug, uw = g - p, w - p
        big = (ug.abs() > lr / 2) & (uw.abs() > lr / 2)
        against += float(((torch.sign(ug) != torch.sign(uw)) & big).sum())
        still += float((ug.abs() <= lr / 2).sum())
        total += g.numel()
        dd += float(((ug - uw) ** 2).sum())
        uu += float((uw ** 2).sum())
    rel = math.sqrt(dd / uu)
    out = dict(max_excess_over_ulp=worst, bound=2.4 * lr,
               moved_against_frac=against / total, update_rel_rms=rel,
               moved_under_half_lr_frac=still / total)
    print(f"{what}: " + ", ".join(f"{k} {v:.4g}" for k, v in out.items()))
    require(worst <= 2.4 * lr, f"{what}: a weight is more than 2 lr apart")
    require(against / total < 5e-3, f"{what}: too many weights moved the "
            "other way")
    if not quantized:
        require(rel < 0.1, f"{what}: the updates differ by {rel:.1%} rms")
    return out


def device_breakdown(prof):
    """Device ms of the profiled step by kernel family (this rank's;
    ``memcpy`` is the copies, gloo's staging through host memory
    included, ``other`` every other kernel: the eager PyTorch ops)."""
    fams = {"gemm": ("gemm_wgmma_kernel", "gemm_f32_kernel",
                     "reduce_groups_kernel"),
            "attention": ("flash_attention_wgmma_kernel",
                          "flash_attention_f32_kernel"),
            "attention_backward": ("attn_bwd",),
            "quantize_int8": ("quantize",),
            "memcpy": ("emcpy",)}
    out = {k: 0.0 for k in fams}
    out["other"] = 0.0
    total = 0.0
    for e in prof.key_averages():
        if "CUDA" not in str(e.device_type):        # kernels, not host ops
            continue
        t = e.self_device_time_total / 1e3
        if t <= 0:
            continue
        total += t
        for k, pats in fams.items():
            if any(pat in e.key for pat in pats):
                out[k] += t
                break
        else:
            out["other"] += t
    out["device_total"] = total
    return out


def device_intervals(prof):
    """``[start, end]`` ns of every device activity (kernels and copies)
    the profiler saw, on the host's epoch clock, to which it aligns the
    card's timestamps: comparable with ``time.time_ns()`` and across the
    ranks of one host."""
    return [[e.start_ns(), e.start_ns() + e.duration_ns()]
            for e in prof.profiler.kineto_results.events()
            if "CUDA" in str(e.device_type()) and e.duration_ns() > 0]


def union_ns(intervals, lo, hi) -> int:
    """ns of ``[lo, hi]`` covered by at least one interval."""
    busy, end = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
            end = e
    return busy


def train_rank(rank, init, batches, run2_path, result_path):
    """One rank of the two-rank train phase (runs 3 and 4, the wire
    control and the timings); writes its results as JSON to
    ``result_path`` with the rank's number in place of ``{}`` (a file, not
    a pipe: the parent reads them after the join, and the profiled step's
    device intervals would fill a pipe's buffer and block the rank)."""
    import torch.distributed as dist
    from repro_torch.api import Session
    from repro_torch.comms import bucketer, compressed
    from repro_torch.comms.plan import CommsPlan, sync_tree
    from repro_torch.core.distributed import close_group, init_group
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as step_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    init_group(init, rank=rank, world_size=RANKS)
    sess = Session(device="cuda")
    out = dict(rank=rank)
    lr1 = TRAIN_PEAK / TRAIN_WARMUP

    # run 3: the fp32 wire, one step from the seed
    plan3 = sess.plan(ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                      comms=CommsPlan(schedule="psum"), adamw=train_adamw(),
                      microbatches=1)
    sess.init_state(plan3, seed=SEED, name="fp32")
    m3 = sess.step(plan3, batches[0], name="fp32")
    p3 = sess.state.pop("fp32")["params"]
    out["run3"] = {k: float(v) for k, v in m3.items()}
    require(same_on_every_rank(params_digest(p3)),
            "fp32 wire: replicas differ after the step")
    p0 = plan3.model.init(SEED)
    if rank == 0:
        run2 = torch.load(run2_path)
        p2 = {k: v.cuda() for k, v in run2["params"].items()}
        out["run3_vs_run2"] = step_agreement(
            p3, p2, p0, lr1, "two ranks, fp32 wire vs one rank, step 1")
        for k in ("loss", "grad_norm"):
            rtol = 1e-3 if k == "loss" else 1e-2
            require(abs(out["run3"][k] - run2["metrics"][k])
                    <= rtol * abs(run2["metrics"][k]),
                    f"fp32 wire vs one rank: {k} {out['run3'][k]} vs "
                    f"{run2['metrics'][k]}")
        del p2, run2
    torch.cuda.empty_cache()

    # run 4: the int8 wire, the main path, TRAIN_STEPS steps
    plan4 = sess.plan(ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                      comms=CommsPlan(schedule="psum", wire_dtype="int8"),
                      adamw=train_adamw(), microbatches=1)
    sess.init_state(plan4, seed=SEED, name="int8")
    dist.barrier()
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    walls, losses, stats = [], [], []
    for s in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        prof = None
        if s == PROFILED:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        dist.barrier()
        t0, t0_ns = time.perf_counter(), time.time_ns()
        m = sess.step(plan4, batches[s], name="int8")
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        if prof is not None:
            t1_ns = time.time_ns()
            prof.__exit__(None, None, None)
            out["profile"] = device_breakdown(prof)
            out["profiled_window_ns"] = [t0_ns, t1_ns]
            out["device_intervals_ns"] = device_intervals(prof)
        m = {k: float(v) for k, v in m.items()}
        losses.append(m["loss"])
        stats.append(m)
        params = sess.state["int8"]["params"]
        require(same_on_every_rank(params_digest(params)),
                f"int8 wire: replicas differ after step {s + 1}")
        if s == 0:
            out["run4_vs_run3"] = step_agreement(
                params, p3, p0, lr1,
                "two ranks, int8 wire vs fp32 wire, step 1", quantized=True)
            require(abs(m["loss"] - out["run3"]["loss"])
                    <= 1e-6 * abs(out["run3"]["loss"]),
                    "int8 and fp32 runs start from different losses")
            del p3, p0
    out["launches"] = ops.dispatch_report()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out.update(step_wall_ms=walls, losses=losses, stats=stats)

    # the first batch again, after the steps: the group's mean loss
    state = sess.state["int8"]
    local = {k: torch.from_numpy(np.asarray(v)).cuda().long()
             .chunk(RANKS)[rank] for k, v in batches[0].items()}
    with torch.no_grad():
        again = plan4.model.loss_fn(state["params"], local)[0].reshape(1)
    dist.all_reduce(again)
    out["first_batch_again"] = float(again) / RANKS

    # the step's parts alone, and the control: one bucket recomputed on
    # the host
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads, _ = step_mod.local_grads(plan4.model, state["params"], local)
    torch.cuda.synchronize()
    out["forward_backward_ms"] = 1e3 * (time.perf_counter() - t0)
    dist.barrier()
    t0 = time.perf_counter()
    sync_tree(grads, plan4.comms)
    torch.cuda.synchronize()
    out["wire_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    opt.apply(plan4.adamw, state["opt"], grads, state["params"])
    torch.cuda.synchronize()
    out["adamw_ms"] = 1e3 * (time.perf_counter() - t0)
    bplan = bucketer.plan_buckets(grads)
    require(bplan.bucket_sizes == BUCKETS,
            f"bucket plan {bplan.bucket_sizes}")
    out["wire_int32_bytes"] = 4 * sum(bplan.bucket_sizes)
    out["wire_int8_format_bytes"] = sum(bplan.bucket_sizes)   # 1 B each
    buckets, absmaxes = bucketer.flatten_buckets_fused(bplan, grads, "int8")
    i = 1                                   # the smallest bucket
    wire = compressed.wire_all_reduce(
        buckets[i].clone(), None, "psum", "int8", absmax=absmaxes[i])
    mine, my_amax = buckets[i].cpu(), absmaxes[i].cpu().reshape(1)
    host = [torch.empty_like(mine) for _ in range(RANKS)]
    dist.all_gather(host, mine)
    amax = [torch.empty_like(my_amax) for _ in range(RANKS)]
    dist.all_gather(amax, my_amax)
    if rank == 0:
        scale = ref.int8_scale(torch.cat(amax).max())
        qs = [ref.quantize_int8(b, scale).to(torch.int32) for b in host]
        full = (sum(qs).float() * scale)
        partial = qs[0].float() * scale
        ok = torch.equal(full, wire.cpu())
        control = torch.equal(partial, wire.cpu())
        print(f"wire control, bucket {i} ({BUCKETS[i]} elements): host "
              f"recompute with both ranks == the wire: {ok}; with rank 1's "
              f"int8 contribution left out: {control} (must be False)")
        require(ok, "the int8 wire's bucket differs from its host recompute")
        require(not control, "the control matches: the check cannot see a "
                "missing rank")
        out["control"] = dict(bucket=i, both_ranks_equal=ok,
                              one_rank_equal=control)
    Path(result_path.format(rank)).write_text(json.dumps(out))
    dist.barrier()
    close_group()


def run_one_rank(cfg, batches):
    """Run 2: one step on one rank, no wire (path gspmd), the whole batch;
    saves the params after the step for the two-rank runs."""
    from repro_torch.api import Session
    sess = Session(device="cuda")
    plan = sess.plan(ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ, comms="off",
                     adamw=train_adamw(), microbatches=1)
    require(plan.path == "gspmd", f"comms='off' took path {plan.path}")
    sess.init_state(plan, seed=SEED)
    n_params = sum(p.numel() for p in sess.state["train_state"]
                   ["params"].values())
    require(n_params == 630_167_424 and cfg.n_layers == 24,
            f"qwen2-0.5b: {n_params} parameters")
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = {k: float(v) for k, v in sess.step(plan, batches[0]).items()}
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    launches = ops.dispatch_report()
    expect = expected_train_launches(cfg, 1, int8=False)
    print(f"run 2 (one rank, no wire, {TRAIN_BATCH}x{TRAIN_SEQ} tokens): "
          f"{m}, {wall:.1f} ms (first step); launches {launches} "
          f"(expected {expect})")
    require(launches == expect, "one-rank train launches do not match the "
            "layer loop")
    require(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
            "one-rank step: non-finite metrics")
    TRAIN_DIR.mkdir(parents=True, exist_ok=True)
    path = TRAIN_DIR / "run2.pt"
    torch.save({"params": {k: v.detach().cpu() for k, v in
                           sess.state["train_state"]["params"].items()},
                "metrics": m}, path)
    return path, dict(metrics=m, first_step_wall_ms=wall)


def check_train_against_cpu(cfg):
    """2 layers at full width, one sequence of 128 tokens: loss, grad
    norm and a few leaves' gradients on the card against the plain
    versions on the CPU, from the same weights."""
    import dataclasses
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as step_mod
    small = dataclasses.replace(cfg, n_layers=2)
    toks = np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, (1, 129))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    card = Model(small, device="cuda")
    params = card.init(SEED)
    runs = []
    for m, dev in ((card, "cuda"), (Model(small, device="cpu"), "cpu")):
        p = {k: v.detach().to(dev).requires_grad_(True)
             for k, v in params.items()}
        g, met = step_mod.local_grads(
            m, p, {k: v.to(dev) for k, v in batch.items()})
        runs.append((g, float(met["loss"]), float(opt.global_norm(g))))
    (gc, lc, nc), (gp, lp, np_) = runs
    out = dict(loss_card=lc, loss_cpu=lp, grad_norm_card=nc,
               grad_norm_cpu=np_)
    require(abs(lc - lp) <= CPU_LOSS_RTOL * abs(lp),
            f"train card vs cpu: loss {lc} vs {lp}")
    require(abs(nc - np_) <= CPU_NORM_RTOL * abs(np_),
            f"train card vs cpu: grad norm {nc} vs {np_}")
    for name in ("embed", "unembed", "layers.attn.wq", "layers.attn.wk",
                 "layers.attn.bv", "layers.mlp.out", "layers.ln1",
                 "final_norm"):
        c, w = gc[name].float().cpu(), gp[name].float()
        rel = float((c - w).norm() / w.norm())
        mx = float((c - w).abs().max() / w.abs().max())
        out[name] = dict(rel_rms=rel, max_abs_frac=mx)
        require(rel <= CPU_GRAD_TOL and mx <= CPU_GRAD_TOL,
                f"train card vs cpu: {name} gradient relative rms {rel:.3g},"
                f" max {mx:.3g} of the largest (tolerance {CPU_GRAD_TOL})")
    print("train card vs cpu (2 layers, full width, 128 tokens): "
          + json.dumps(out))
    return out


def steady_wall(rank_result) -> float:
    """Median wall ms of the steps after the first, the profiled one
    left out."""
    return statistics.median(
        w for i, w in enumerate(rank_result["step_wall_ms"])
        if i not in (0, PROFILED))


def profiled_idle(ranks):
    """Busy and idle time of the card over the profiled step.

    ``card``: the union of both ranks' device intervals (kernels and
    copies; the ranks' kernels overlap on the one card) over one window,
    from the first rank's start to the last rank's end of that step.  Per
    rank: the step's wall time, the union of its own device intervals, and
    the rest (host time: its work was not on the card).  The profiler's
    host tracing slows the step a little, so its wall time runs above the
    unprofiled steps' median.  If a rank's device intervals do not fall
    inside its own step on the host clock, the clocks are not aligned and
    the card's share is not measured (None)."""
    per_rank, aligned = [], True
    for r in ranks:
        lo, hi = r["profiled_window_ns"]
        iv = r["device_intervals_ns"]
        require(iv, f"rank {r['rank']}: the profiler saw no device work")
        slack = 1_000_000
        aligned &= (min(s for s, _ in iv) >= lo - slack
                    and max(e for _, e in iv) <= hi + slack)
        busy = union_ns(iv, min(s for s, _ in iv), max(e for _, e in iv))
        per_rank.append(dict(wall_ms=(hi - lo) / 1e6, device_ms=busy / 1e6,
                             host_ms=(hi - lo - busy) / 1e6))
    card = dict(clocks_aligned=aligned, wall_ms=None, device_busy_ms=None,
                device_idle_share=None)
    if aligned:
        lo = min(r["profiled_window_ns"][0] for r in ranks)
        hi = max(r["profiled_window_ns"][1] for r in ranks)
        busy = union_ns([iv for r in ranks
                         for iv in r["device_intervals_ns"]], lo, hi)
        card.update(wall_ms=(hi - lo) / 1e6, device_busy_ms=busy / 1e6,
                    device_idle_share=1 - busy / (hi - lo))
    print("profiled step: card " + json.dumps(card) + "; per rank "
          + json.dumps(per_rank))
    return dict(card=card, ranks=per_rank)


def train_phase(cfg):
    """Run 2 here, runs 3 and 4 in two spawned ranks sharing the card
    over gloo; the card-vs-CPU check; returns the summary and the launch
    counts of the main path (run 4, summed over the ranks)."""
    import torch.multiprocessing as mp
    batches = train_batches(cfg)
    run2_path, run2 = run_one_rank(cfg, batches)
    torch.cuda.empty_cache()
    cpu_check = check_train_against_cpu(cfg)
    torch.cuda.empty_cache()
    init = f"file://{TRAIN_DIR / 'rendezvous'}"
    (TRAIN_DIR / "rendezvous").unlink(missing_ok=True)
    results = [TRAIN_DIR / f"rank{r}.json" for r in range(RANKS)]
    for f in results:
        f.unlink(missing_ok=True)
    try:
        mp.spawn(train_rank, args=(init, batches, str(run2_path),
                                   str(TRAIN_DIR / "rank{}.json")),
                 nprocs=RANKS, join=True)
    finally:
        run2_path.unlink(missing_ok=True)
    ranks = [json.loads(f.read_text()) for f in results]
    for f in results:
        f.unlink()
    expect = expected_train_launches(cfg, TRAIN_STEPS, int8=True)
    for r in ranks:
        print(f"rank {r['rank']} launches over {TRAIN_STEPS} int8-wire "
              f"steps: {r['launches']} (expected {expect})")
        require(r["launches"]["quantize_int8"] > 0
                and r["launches"]["attention_backward"] > 0,
                "a kernel of the train path was never launched")
        require(r["launches"] == expect,
                "train launches do not match the layer loop")
    losses = ranks[0]["losses"]
    require(all(r["losses"] == losses for r in ranks),
            "ranks report different losses")
    again = ranks[0]["first_batch_again"]
    print(f"int8-wire losses over {TRAIN_STEPS} steps: {losses}; the first "
          f"batch after them: {again}")
    require(all(map(math.isfinite, losses)) and losses[-1] < losses[0]
            and again < losses[0], "the loss did not fall")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    wall = steady_wall(ranks[0])
    idle = profiled_idle(ranks)
    summary = dict(
        arch=ARCH, params=630_167_424, ranks=RANKS,
        global_batch_tokens=tokens, steps=TRAIN_STEPS, losses=losses,
        first_batch_loss_after=again,
        run2=run2, run3=ranks[0]["run3"],
        run3_vs_run2=ranks[0]["run3_vs_run2"],
        run4_vs_run3=ranks[0]["run4_vs_run3"], control=ranks[0]["control"],
        card_vs_cpu=cpu_check, step_wall_ms_median=wall,
        tokens_per_s=tokens / (wall / 1e3), profiled_step=idle["card"],
        per_rank=[dict(
            rank=r["rank"], step_wall_ms=r["step_wall_ms"],
            step_wall_ms_median=steady_wall(r),
            profiled_step=idle["ranks"][i],
            forward_backward_ms=r["forward_backward_ms"],
            wire_ms=r["wire_ms"], adamw_ms=r["adamw_ms"],
            peak_gib=r["peak_gib"], profile=r["profile"])
            for i, r in enumerate(ranks)],
        wire_int32_bytes_per_rank=ranks[0]["wire_int32_bytes"],
        wire_int8_format_bytes_per_rank=ranks[0]["wire_int8_format_bytes"])
    print("train " + json.dumps(summary), flush=True)
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    return summary, launches


# ---------------------------------------------------------------------------
# phase 7: compressed data-parallel SGD, qwen2-0.5b at full width
# ---------------------------------------------------------------------------

DP_SCHEMES, DP_STEPS = ("none", "onebit", "int8"), 3
# Plain SGD with momentum 0.9 moves a weight by lr times its gradient:
# most of qwen2-0.5b's bf16 weights (|w| ~ 0.02, one ulp ~ 1e-4) keep
# their value unless lr * |g| reaches half an ulp, so the rate is far
# above AdamW's 1e-4.
DP_LR, DP_MOMENTUM = 0.1, 0.9
DP_PATH = (f"{ARCH} compressed DP SGD ({RANKS} ranks, int8, {DP_STEPS} "
           "steps)")


def expected_dp_launches(cfg, scheme: str):
    """Per rank over the ``DP_STEPS`` steps: the train layer loop (remat
    ``full``, as the model's default), and one ``quantize_compress`` per
    parameter leaf per int8 step."""
    expect = expected_train_launches(cfg, DP_STEPS, int8=False)
    leaves = len(leaf_lengths(cfg))
    expect["quantize_compress"] = DP_STEPS * leaves if scheme == "int8" else 0
    return expect


def ulps_apart(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in units of fp32 spacing at |b|."""
    spacing = torch.nextafter(b.abs(), torch.full_like(b, math.inf)) - b.abs()
    return (a - b).abs() / spacing


def dp_step1_check(scheme, synced, local, group_sum):
    """Checks of step 1 (the seed's params, the first batch), with no
    kernel of the port launched: ``none`` gives the bf16 mean of the
    local gradients computed before the steps, bitwise (so the step's
    local gradients are those); ``int8`` lies within (s0 + s1) / 4 of the
    fp32 mean of the two local gradients, plus fp32 rounding (each rank's
    dequantized value lies within half its scale s_r of its gradient)."""
    from repro_torch.comms import schedules
    out = {}
    if scheme == "none":
        same = all(torch.equal(
            synced[k], schedules.all_reduce(g.clone()) / torch.full(
                (), RANKS, dtype=g.dtype, device=g.device))
            for k, g in local.items())
        require(same, "none, step 1: the synced gradients are not the mean "
                "of the local gradients computed alone")
        out["bf16_mean_bitwise"] = same
    if scheme == "int8":
        worst = 0.0
        for k, g in local.items():
            v = g.float()
            exact = schedules.all_reduce(v.clone()) / torch.full(
                (), RANKS, device=v.device)
            s_sum = group_sum(ref.int8_scale(v.abs().max()))
            d = (synced[k] - exact).abs()
            slack = 2.0 ** -23 * (64 * s_sum + synced[k].abs() + exact.abs())
            require(not bool((d > s_sum / 4 + slack).any()),
                    f"int8, step 1, {k}: the synced gradient is more than "
                    "(s0 + s1) / 4 from the exact mean")
            worst = max(worst, float(d.max()) / (float(s_sum) / 4))
        out["max_err_over_quarter_scale_sum"] = worst
    return out


def dp_ef_check(scheme, local, err_digest):
    """Error feedback at step 1, after the counted window: the quantizer
    on the local gradients (zero error state) gives the step's new error
    state, bitwise, and ``deq + err`` gives back ``v``: int8 bitwise or
    within one rounding (one fp32 spacing of v), onebit within the
    reference's rtol 1e-5 (``tests/test_properties.py``)."""
    from repro_torch.train import compression as comp
    quant = getattr(comp, f"quantize_{scheme}")
    exact = total = 0
    worst = 0.0
    for k, g in local.items():
        v = g.float()
        deq, e = quant(g, torch.zeros_like(v))
        back = deq + e
        total += v.numel()
        if scheme == "int8":
            exact += int((back == v).sum())
            worst = max(worst, float(ulps_apart(back, v).max()))
        else:
            worst = max(worst, float(((back - v).abs() / (
                1e-6 + 1e-5 * v.abs())).max()))
        del deq, back
        err_digest_k = params_digest({k: e})
        require(torch.equal(err_digest_k, err_digest[k]),
                f"{scheme}: the step's error state for {k} is not the "
                "quantizer's")
    if scheme == "int8":
        require(worst <= 1.0, f"int8: deq + err is {worst} fp32 spacings "
                "from v")
        return dict(bitwise_share=exact / total, max_spacings=worst)
    require(worst <= 1.0, "onebit: deq + err is beyond rtol 1e-5 of v")
    return dict(max_over_tolerance=worst)


def dp_timings(scheme, loss_fn, params, local0, local):
    """The step's parts alone, after the counted window: forward and
    backward on the rank's rows, ``compressed_psum`` (quantize and wire),
    and the quantizer alone (wire = the difference)."""
    import torch.distributed as dist
    from repro_torch.train import compression as comp
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.autograd.grad(loss_fn(params, local0), list(params.values()))
    torch.cuda.synchronize()
    out["forward_backward_ms"] = 1e3 * (time.perf_counter() - t0)
    zeros = comp.init_error_state(local)
    grads = {k: g.clone() for k, g in local.items()}
    dist.barrier()
    t0 = time.perf_counter()
    comp.compressed_psum(grads, zeros, None, scheme)
    torch.cuda.synchronize()
    out["compressed_psum_ms"] = 1e3 * (time.perf_counter() - t0)
    out["quantizer_ms"] = 0.0
    if scheme != "none":
        quant = getattr(comp, f"quantize_{scheme}")
        t0 = time.perf_counter()
        for k, g in local.items():
            quant(g, zeros[k])
        torch.cuda.synchronize()
        out["quantizer_ms"] = 1e3 * (time.perf_counter() - t0)
    out["wire_ms"] = out["compressed_psum_ms"] - out["quantizer_ms"]
    return out


def dp_rank(rank, init, batches, result_path):
    """One rank of phase 7: ``build_dp_sgd_step`` over the model's loss,
    ``DP_STEPS`` steps per scheme from the seed's params, each scheme's
    steps a counted window; writes its results as JSON to ``result_path``
    with the rank's number in place of ``{}``."""
    import torch.distributed as dist
    from repro_torch.core.distributed import close_group, init_group
    from repro_torch.train import compression as comp

    torch.backends.cuda.matmul.allow_tf32 = False
    init_group(init, rank=rank, world_size=RANKS)
    cfg = get_config(ARCH)
    model = Model(cfg, device="cuda")

    def loss_fn(p, b):
        return model.loss_fn(p, b)[0]

    def group_sum(x: torch.Tensor) -> torch.Tensor:
        x = x.detach().float().reshape(1).clone()
        dist.all_reduce(x)
        return x.reshape(())

    def fresh():
        return {k: v.requires_grad_(True)
                for k, v in model.init(SEED).items()}

    gb = [{k: torch.from_numpy(np.asarray(v)).cuda().long()
           for k, v in b.items()} for b in batches[:DP_STEPS]]
    local0 = {k: v.chunk(RANKS)[rank] for k, v in gb[0].items()}
    # step 1's local gradients, computed alone: every scheme's step 1
    # computes the same ones (the seed's params, this rank's rows of the
    # first batch; no kernel uses atomics, so bitwise)
    params = fresh()
    with torch.no_grad():
        first_before = float(group_sum(loss_fn(params, local0))) / RANKS
    local = dict(zip(params, torch.autograd.grad(
        loss_fn(params, local0), list(params.values()))))
    del params
    out = dict(rank=rank, first_batch_before=first_before, schemes={})
    for scheme in DP_SCHEMES:
        params = fresh()
        vel = {k: torch.zeros_like(p) for k, p in params.items()}
        err = comp.init_error_state(params)
        step = comp.build_dp_sgd_step(loss_fn, scheme=scheme, lr=DP_LR,
                                      momentum=DP_MOMENTUM)
        res = dict(step_wall_ms=[], losses=[])
        torch.cuda.synchronize()
        dist.barrier()
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        for s in range(DP_STEPS):
            dist.barrier()
            t0 = time.perf_counter()
            r = step(params, vel, err, gb[s])
            torch.cuda.synchronize()
            res["step_wall_ms"].append(1e3 * (time.perf_counter() - t0))
            res["losses"].append(float(group_sum(r["loss"])) / RANKS)
            require(same_on_every_rank(params_digest(params))
                    and same_on_every_rank(params_digest(vel)),
                    f"{scheme}: replicas differ after step {s + 1}")
            if s == 0:
                res["step1"] = dp_step1_check(scheme, r["grads"], local,
                                              group_sum)
                err1 = {k: params_digest({k: e}) for k, e in err.items()}
            del r
        res["launches"] = ops.dispatch_report()
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        res["vel_dtypes"] = sorted({str(v.dtype) for v in vel.values()})
        if scheme == "none":
            with torch.no_grad():
                res["first_batch_after"] = float(group_sum(
                    loss_fn(params, local0))) / RANKS
        else:
            res["err_same_on_every_rank"] = same_on_every_rank(
                params_digest(err))
            res["error_feedback"] = dp_ef_check(scheme, local, err1)
        res.update(dp_timings(scheme, loss_fn, params, local0, local))
        res["wire_bytes"] = comp.wire_bytes(params, scheme)
        out["schemes"][scheme] = res
        del params, vel, err, step
        torch.cuda.empty_cache()
    Path(result_path.format(rank)).write_text(json.dumps(out))
    dist.barrier()
    close_group()


def dp_phase(cfg):
    """Phase 7: two ranks spawned on the one card over gloo run the three
    schemes; returns the summary and the int8 run's launch counts summed
    over the ranks (the path's main window)."""
    import torch.multiprocessing as mp
    batches = train_batches(cfg)
    TRAIN_DIR.mkdir(parents=True, exist_ok=True)
    init = f"file://{TRAIN_DIR / 'rendezvous_dp'}"
    (TRAIN_DIR / "rendezvous_dp").unlink(missing_ok=True)
    results = [TRAIN_DIR / f"dp_rank{r}.json" for r in range(RANKS)]
    for f in results:
        f.unlink(missing_ok=True)
    mp.spawn(dp_rank, args=(init, batches, str(TRAIN_DIR / "dp_rank{}.json")),
             nprocs=RANKS, join=True)
    ranks = [json.loads(f.read_text()) for f in results]
    for f in results:
        f.unlink()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    summary = dict(arch=ARCH, params=630_167_424, ranks=RANKS,
                   global_batch_tokens=tokens, steps=DP_STEPS, lr=DP_LR,
                   momentum=DP_MOMENTUM,
                   first_batch_before=ranks[0]["first_batch_before"],
                   schemes={})
    for scheme in DP_SCHEMES:
        rs = [r["schemes"][scheme] for r in ranks]
        expect = expected_dp_launches(cfg, scheme)
        for r, res in zip(ranks, rs):
            print(f"rank {r['rank']} {scheme}: launches {res['launches']} "
                  f"(expected {expect})")
            require(res["launches"] == expect, f"{scheme}: launches do not "
                    "match the layer loop")
        require(all(res["losses"] == rs[0]["losses"] for res in rs),
                f"{scheme}: ranks report different losses")
        require(all(map(math.isfinite, rs[0]["losses"])),
                f"{scheme}: non-finite loss")
        wall = statistics.median(rs[0]["step_wall_ms"])
        row = dict(losses=rs[0]["losses"], step_wall_ms_median=wall,
                   tokens_per_s=tokens / (wall / 1e3),
                   wire_bytes_per_rank=rs[0]["wire_bytes"],
                   vel_dtypes=rs[0]["vel_dtypes"],
                   per_rank=[{k: res[k] for k in (
                       "step_wall_ms", "peak_gib", "forward_backward_ms",
                       "compressed_psum_ms", "quantizer_ms", "wire_ms")}
                       for res in rs],
                   step1=rs[0]["step1"])
        for key in ("first_batch_after", "error_feedback",
                    "err_same_on_every_rank"):
            if key in rs[0]:
                row[key] = [res[key] for res in rs] if key != \
                    "first_batch_after" else rs[0][key]
        summary["schemes"][scheme] = row
    none = summary["schemes"]["none"]
    print(f"compressed DP SGD, none: first batch {summary['first_batch_before']}"
          f" before the steps, {none['first_batch_after']} after")
    require(none["first_batch_after"] < summary["first_batch_before"],
            "none: the first batch's loss did not fall")
    int8 = [r["schemes"]["int8"]["launches"] for r in ranks]
    require(all(x["quantize_compress"] > 0 and x["matmul"] > 0
                and x["attention_backward"] > 0 for x in int8),
            "a kernel of the compressed DP path was never launched")
    print("dp_sgd " + json.dumps(summary), flush=True)
    return summary, {k: sum(x[k] for x in int8) for k in int8[0]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device facts
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"device: {name} (count {count}); nvidia-smi: {smi}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)

    # 3. kernels against their plain versions, times and bounds
    cfg = get_config(ARCH)
    rows = [check_gemm(cfg), check_flash(cfg), check_paged(cfg), check_ssd()]
    rows[0]["properties_checked"] = check_gemm_properties(
        cfg, get_config(MAMBA))
    rows[1]["properties_checked"] = check_flash_properties(cfg)
    sys.stdout.flush()

    # 4. qwen2-0.5b at full width
    model = Model(cfg, device="cuda")
    params = model.init(SEED)
    n_params = sum(p.numel() for p in params.values())
    serve(ContinuousEngine, model, params, requests(cfg)[:2])    # warm-up
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    fin, dt, steps = serve(ContinuousEngine, model, params, requests(cfg))
    launches = ops.dispatch_report()
    peak = torch.cuda.max_memory_allocated()
    chunks = sum(-(-len(r.prompt) // CHUNK) for r in fin)
    L = cfg.n_layers
    per_pass = 7 * L + 1
    expect = {"matmul": per_pass * (steps + chunks),
              "attention": L * chunks, "attention_backward": 0,
              "paged_decode_attention": L * steps, "ssd": 0,
              "quantize_int8": 0, "quantize_compress": 0, "matmul_dequant": 0}
    print(f"launches: {launches} (expected {expect}: {steps} decode steps, "
          f"{chunks} prefill chunks)")
    require(all(launches[k] > 0 for k in
                ("matmul", "attention", "paged_decode_attention")),
            "a kernel of the serve path was never launched")
    require(launches == expect, "launch counts do not match the layer loop")
    serve_stats_q = serve_stats(ARCH, n_params, fin, dt, launches, peak,
                                resident)
    serve_stats_q.update(decode_steps=steps, prefill_chunks=chunks,
                         **step_breakdown(cfg, model, params))
    print("serve " + json.dumps(serve_stats_q), flush=True)

    static, _, _ = serve(Engine, model, params, requests(cfg), paged=True)
    cont = {r.rid: r.out for r in fin}
    same = cont == {r.rid: r.out for r in static}
    print(f"static paged == continuous greedy tokens: {same}")
    require(same, "static paged and continuous engines disagree")
    check_against_cpu(cfg, model, params)
    del model, params
    torch.cuda.empty_cache()

    # 5. mamba2-780m at full width
    mamba_stats, mamba_launches = serve_mamba()
    rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"],
                                 mamba_stats["gemm_max_abs_err"])

    # 6. train qwen2-0.5b at full width, two ranks on the card
    rows += [check_quantize(), check_attention_backward(cfg)]
    gemm_train = check_gemm_backward(cfg)
    rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"],
                                 gemm_train.pop("max_abs_err"))
    rows[0].update(gemm_train)
    for key in ("with_lse_ms", "bound_ms", "bound_by", "library_ms"):
        rows[1]["train_forward_" + key] = rows[-1].pop("forward_" + key)
    _, train_launches = train_phase(cfg)
    torch.cuda.empty_cache()

    # 7. compressed data-parallel SGD at full width, two ranks on the card
    rows += [check_quantize_compress(cfg), check_matmul_dequant(cfg)]
    torch.cuda.empty_cache()
    _, dp_launches = dp_phase(cfg)

    # 8. results
    names = {"gemm": "matmul", "flash_attention": "attention",
             "paged_decode_attention": "paged_decode_attention",
             "ssd": "ssd", "quantize_int8": "quantize_int8",
             "attention_backward": "attention_backward",
             "quantize_compress": "quantize_compress",
             "matmul_dequant": "matmul_dequant"}
    train_path = (f"{ARCH} train ({RANKS} ranks, int8 wire, {TRAIN_STEPS} "
                  "steps)")
    for row in rows:
        op = names[row["name"]]
        row["launches_by_path"] = {ARCH: launches[op],
                                   MAMBA: mamba_launches[op],
                                   train_path: train_launches[op],
                                   DP_PATH: dp_launches[op]}
        row["launches"] = sum(row["launches_by_path"].values())
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
