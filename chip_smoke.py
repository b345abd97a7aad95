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
4. Serve qwen2-0.5b at full width (random weights from a seed) through
   ``ContinuousEngine``: 16 requests, prompts of 64-512 tokens, 64 new
   tokens each.  Launch counts are zeroed just before and read just after;
   each kernel must have run, exactly as often as the model's layer loop
   says.  The same requests through the static paged ``Engine`` must give
   identical greedy tokens, and the card's logits must agree with the
   plain versions' on the CPU on a short prompt.  One decode step is also
   split into its host wall time and its device time.
5. Print the ``kernels`` JSON line, the card's name and power limit, and
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
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import ContinuousEngine, Engine, Request  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
L2_BYTES = 50e6
RTOL, ATOL = 3e-2, 2e-2            # bf16: 8 mantissa bits, fp32 sums

ARCH = "qwen2-0.5b"
SEED = 0
N_REQUESTS, PROMPT_MIN, PROMPT_MAX, NEW_TOKENS = 16, 64, 512, 64
SLOTS, MAX_SEQ, PAGE, CHUNK = 8, 1024, 64, 128


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
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


# ---------------------------------------------------------------------------
# phase 4: serve at full width
# ---------------------------------------------------------------------------

def requests(cfg):
    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT_MIN, PROMPT_MAX + 1, N_REQUESTS)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, int(n))
                    .astype(np.int32), max_new_tokens=NEW_TOKENS)
            for i, n in enumerate(lens)]


def serve(engine_cls, model, params, reqs):
    """Drive an engine to completion; returns (finished, seconds, decode
    steps, prefill chunks)."""
    eng = engine_cls(model, params, batch_slots=SLOTS, max_seq=MAX_SEQ,
                     page_size=PAGE, prefill_chunk=CHUNK)
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
    chunks = sum(-(-len(r.prompt) // CHUNK) for r in eng.finished)
    require(len(eng.finished) == len(reqs) and not eng.refused
            and not any(r.n_preempted for r in eng.finished),
            f"{engine_cls.__name__}: {len(eng.finished)} of {len(reqs)} "
            "requests finished without preemption")
    return eng.finished, dt, steps, chunks


def check_against_cpu(cfg, model, params):
    """A short prompt through prefill and 4 decode steps on the card and
    through the plain versions on the CPU, teacher-forced with the CPU's
    greedy tokens.  bf16 activations round at other places on the two
    devices, and the difference grows with depth: 0.32% of the largest
    logit at 2 layers (tests/test_torch_serve.py), so up to ~4% at 24 if
    it grows linearly.  Logits must agree within 5% of the largest logit;
    greedy tokens must agree wherever the CPU's top-1/top-2 margin
    exceeds twice that."""
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
    got = torch.stack(runs[0][3])
    want = torch.stack(runs[1][3])
    require(bool(torch.isfinite(got).all()), "card logits not finite")
    atol = 5e-2 * float(want.abs().max())
    diff = float((got - want).abs().max())
    rel_rms = float((got - want).norm() / want.norm())
    top2 = torch.topk(want, 2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * atol
    agree = bool((got.argmax(-1)[sure] == want.argmax(-1)[sure]).all())
    same = int((got.argmax(-1) == want.argmax(-1)).sum())
    print(f"card vs cpu logits (full width, 64-token prompt + 4 steps): "
          f"max abs diff {diff:.4g} = {diff / float(want.abs().max()):.2%} "
          f"of the largest logit (tolerance 5%), relative rms "
          f"{rel_rms:.3%}; greedy tokens equal on {same}/{len(want)} steps, "
          f"required on the {int(sure.sum())} with a margin over "
          f"{2 * atol:.3g}: {agree}")
    require(diff <= atol and agree, "card logits disagree with the CPU's")


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

    def step():
        return model.decode_step_paged(params, cache, tokens, pos)[0]

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    device = cuda_ms([step], iters=5, warmup=1)
    wall = statistics.median(walls)
    print(f"decode step (8 slots, full width): eager wall {wall:.3f} ms, "
          f"device (graph replay) {device:.3f} ms, device idle share of "
          f"the eager step {1 - device / wall:.1%}")
    return dict(decode_step_wall_ms=wall, decode_step_device_ms=device)


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
    rows = [check_gemm(cfg), check_flash(cfg), check_paged(cfg)]
    sys.stdout.flush()

    # 4. serve at full width
    model = Model(cfg, device="cuda")
    params = model.init(SEED)
    n_params = sum(p.numel() for p in params.values())
    serve(ContinuousEngine, model, params, requests(cfg)[:2])    # warm-up
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    fin, dt, steps, chunks = serve(ContinuousEngine, model, params,
                                   requests(cfg))
    launches = ops.dispatch_report()
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    per_pass = 7 * L + 1
    expect = {"matmul": per_pass * (steps + chunks),
              "attention": L * chunks, "paged_decode_attention": L * steps}
    print(f"launches: {launches} (expected {expect}: {steps} decode steps, "
          f"{chunks} prefill chunks)")
    require(all(v > 0 for v in launches.values()),
            "a kernel of the serve path was never launched")
    require(launches == expect, "launch counts do not match the layer loop")

    tokens = sum(len(r.out) for r in fin)
    ttft = [r.first_token_t - r.submit_t for r in fin]
    per_tok = [(r.finish_t - r.first_token_t) / (len(r.out) - 1)
               for r in fin]
    serve_stats = dict(
        arch=ARCH, params=n_params, requests=len(fin), tokens=tokens,
        seconds=dt, tok_per_s=tokens / dt,
        ttft_p50_ms=1e3 * statistics.median(ttft),
        decode_ms_per_token_p50=1e3 * statistics.median(per_tok),
        decode_steps=steps, prefill_chunks=chunks,
        resident_before_gib=resident / 2**30, peak_mem_gib=peak / 2**30,
        launches=launches,
        **step_breakdown(cfg, model, params))
    print("serve " + json.dumps(serve_stats), flush=True)

    static, _, _, _ = serve(Engine, model, params, requests(cfg))
    cont = {r.rid: r.out for r in fin}
    same = cont == {r.rid: r.out for r in static}
    print(f"static paged == continuous greedy tokens: {same}")
    require(same, "static paged and continuous engines disagree")
    check_against_cpu(cfg, model, params)

    # 5. results
    names = {"gemm": "matmul", "flash_attention": "attention",
             "paged_decode_attention": "paged_decode_attention"}
    for row in rows:
        row["launches"] = launches[names[row["name"]]]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
