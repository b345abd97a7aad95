"""Host time of the port's flash-attention wrappers on one CUDA card.

For qwen2-0.5b's heads (14 query heads, 2 kv heads, head dim 64, bf16,
random inputs from seed 0), host microseconds per call of:

- ``ops.attention`` on one prefill chunk (q (1,14,128,64) at q_offset
  384 against T = 512, no autograd): what the serve path calls 24 times
  per chunk;
- the forward with its log-sum-exp (``flash_attention._forward``) and
  ``flash_attention.attention_backward`` at the train shape (q
  (2,14,512,64), causal): what a train step calls 48 and 24 times per
  rank;
- ``torch.nn.functional.scaled_dot_product_attention`` on the same
  prefill chunk (a yardstick; the port never calls it);
- the forward's C entry alone, its outputs made beforehand (the launch
  and the C side's host work).

Each is issued ``--calls`` times back to back on an idle card and timed
on the host clock from the first call to the last return, with no
synchronize in between; the median of ``--steps`` such passes.

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so a second checkout, for example the parent
commit unpacked with ``git archive`` under ``build/``, is timed by the
same code.  Compare two trees within one machine, interleaved:

    python3 scripts/attention_host_cost.py --src build/parent/src --label parent
    python3 scripts/attention_host_cost.py --label change

Each run prints the card's name and power limit and one JSON line.
Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
H, HKV, HD, CHUNK, T_PREFILL, SEED = 14, 2, 64, 128, 512, 0
TRAIN_B, TRAIN_S = 2, 512


def host_us(fn, calls: int, steps: int) -> float:
    """Median host microseconds per call of ``fn()`` over ``steps``
    passes of ``calls`` calls."""
    for _ in range(3):
        fn()
    per_call = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append(1e6 * (time.perf_counter() - t0) / calls)
    torch.cuda.synchronize()
    return statistics.median(per_call)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="change")
    ap.add_argument("--calls", type=int, default=24)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_host_cost: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as fa

    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def rand(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    start = T_PREFILL - CHUNK
    q, k, v = (rand(1, H, CHUNK, HD), rand(1, HKV, T_PREFILL, HD),
               rand(1, HKV, T_PREFILL, HD))
    n, s = args.calls, args.steps
    out = dict(label=args.label, src=args.src, calls_per_pass=n)
    out["prefill_attention_host_us_per_call"] = host_us(
        lambda: ops.attention(q, k, v, causal=True, q_offset=start), n, s)
    mask = (torch.arange(CHUNK, device="cuda")[:, None] + start
            >= torch.arange(T_PREFILL, device="cuda")[None, :])
    out["prefill_sdpa_host_us_per_call"] = host_us(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), n, s)
    o = torch.empty_like(q)
    fn = _build.function("dmath_flash_attention_bf16", fa._ARGTYPES)
    entry = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None,
             1, H, HKV, CHUNK, T_PREFILL, HD, 1, 0, 0.0, HD ** -0.5, start,
             torch.cuda.current_stream().cuda_stream)
    out["prefill_entry_host_us_per_call"] = host_us(
        lambda: _build.check(fn(*entry), "attention"), n, s)

    tq, tdo = rand(TRAIN_B, H, TRAIN_S, HD), rand(TRAIN_B, H, TRAIN_S, HD)
    tk, tv = rand(TRAIN_B, HKV, TRAIN_S, HD), rand(TRAIN_B, HKV, TRAIN_S, HD)
    fwd_args = (True, None, None, HD ** -0.5, 0)
    out["train_forward_with_lse_host_us_per_call"] = host_us(
        lambda: fa._forward(tq, tk, tv, *fwd_args, with_lse=True), n, s)
    to, tlse = fa._forward(tq, tk, tv, *fwd_args, with_lse=True)
    out["train_backward_host_us_per_call"] = host_us(
        lambda: fa.attention_backward(tq, tk, tv, to, tdo, tlse), n, s)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
