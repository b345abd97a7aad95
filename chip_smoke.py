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
   at a ragged prefill M = 300, and time them; split a decode step into
   GEMM, the plain ``ssd_step`` and convolutions, other device work and
   host time; hold the card's prefill states and logits against the
   CPU's (with controls that must fail), and prefill-then-decode against
   the full forward.
6. Print the ``kernels`` JSON line, the card's name and power limit, and
   last the ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import json
import math
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


def randn(shape, seed: int, scale: float = 1.0) -> torch.Tensor:
    x = torch.randn(shape, generator=gen(seed), device="cuda")
    return (x * scale).to(torch.bfloat16)


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


def check_gemm(cfg):
    step = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                bytes=0.0, flops=0.0)
    errs = []
    print("gemm: M K N | kernel ms | bound ms (by) | plain ms | "
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
            print(f"gemm {label:7s} {M:4d} {K:5d} {N:6d} | {ms:.4f} | "
                  f"{bms:.4f} ({by}) | {plain:.4f} | {lib:.4f} | {err:.3g}")
            if M == SLOTS:
                for key, val in (("ms", ms), ("plain_ms", plain),
                                 ("library_ms", lib), ("bound_ms", bms),
                                 ("bytes", nbytes), ("flops", flops)):
                    step[key] += calls * val
    bms, by = bound(step["bytes"], step["flops"])
    print(f"gemm: one decode step ({sum(c for *_, c in gemm_cases(cfg))} "
          f"calls, M={SLOTS}): {step['ms']:.4f} ms, bound {bms:.4f} ms "
          f"({by}), plain {step['plain_ms']:.4f} ms, torch.matmul "
          f"{step['library_ms']:.4f} ms")
    return dict(name="gemm", route="cuda",
                source="src/repro_torch/kernels/csrc/gemm.cu",
                replaces="src/repro/kernels/gemm.py:45",
                case=f"one decode step: the 169 products at M={SLOTS}",
                max_abs_err=max(errs), ms=step["ms"],
                plain_ms=step["plain_ms"], bound_ms=bms, bound_by=by,
                library_ms=step["library_ms"])


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
    shape (``wdt``'s N = 48 is the one ragged N of either model, ``w_out``
    the one K = 3072), at M = 8 (a decode step) and at a ragged prefill
    M = PREFILL_M, each timed with L2-cold weights.  Returns the sums over
    the 241 calls of a decode step and of a PREFILL_M-token prefill."""
    out = dict(gemm_ms=0.0, gemm_bound_ms=0.0, prefill_gemm_ms=0.0,
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
            bms, _ = bound(2 * (M * K + K * N) + 4 * M * N, 2.0 * M * N * K)
            print(f"mamba2 gemm {label:7s} M={M} K={K} N={N}: {ms:.4f} ms "
                  f"x {calls} (bound {bms:.4f} ms), max abs err {err:.3g}")
            out[f"{key}_ms"] += calls * ms
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
              "paged_decode_attention": 0, "ssd": L * prefills}
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
              "attention": L * chunks, "paged_decode_attention": L * steps,
              "ssd": 0}
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

    # 6. results
    names = {"gemm": "matmul", "flash_attention": "attention",
             "paged_decode_attention": "paged_decode_attention",
             "ssd": "ssd"}
    for row in rows:
        op = names[row["name"]]
        row["launches_by_path"] = {ARCH: launches[op],
                                   MAMBA: mamba_launches[op]}
        row["launches"] = launches[op] + mamba_launches[op]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
