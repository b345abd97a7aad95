"""Host time of the port's GEMM wrapper, and of a full-width decode step,
on one CUDA card.

For qwen2-0.5b at full width (random weights from seed 0):

- host microseconds per ``ops.matmul`` call: the 169 products of one
  decode step (M = 8 tokens, bf16, one weight matrix per product) issued
  back to back on an idle card, timed on the host clock from the first
  call to the last return, with no synchronize in between (the launch
  queue has room for them all, so the device's time does not show);
  the median of 20 such steps.  The same for ``torch.matmul`` on the
  same operands, and, where the tree's wrapper has a plan
  (``gemm.plan``), for its C entry alone, called with arguments made
  before the clock starts (the launches and the C side's host work).
- where the tree's wrappers test for a fake tensor (the dry trace's
  ``isinstance(a, FakeTensor)``, once a call in ``gemm._product`` and in
  ``paged_decode_attention``), host microseconds per call of that test
  alone over the same 169 operands, beside the same loop calling a
  function that does nothing; their difference is the test's cost.
- one eager decode step (8 slots, ``Model.decode_step_paged``): its host
  time to the call's return and its wall time to a synchronize, medians
  of 20.

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so a second checkout, for example the parent
commit unpacked with ``git archive`` under ``build/``, is timed by the
same code.  Compare two trees within one machine, interleaved:

    python3 scripts/gemm_host_cost.py --src build/parent/src --label parent
    python3 scripts/gemm_host_cost.py --label change

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

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
ARCH, SEED, SLOTS, MAX_SEQ, PAGE = "qwen2-0.5b", 0, 8, 1024, 64


def host_us(fn, products, steps: int) -> float:
    """Median host microseconds per call of ``fn`` over ``steps`` passes
    through ``products`` (tuples of its arguments)."""
    for _ in range(3):
        for args in products:
            fn(*args)
    per_call = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for args in products:
            fn(*args)
        per_call.append(1e6 * (time.perf_counter() - t0) / len(products))
    torch.cuda.synchronize()
    return statistics.median(per_call)


def entry_us(products, steps: int):
    """Host microseconds per call of the GEMM's C entry alone, its
    arguments (outputs and split scratch included) made beforehand; None
    for a wrapper without a plan."""
    from repro_torch.kernels import _build, gemm
    if not hasattr(gemm, "plan"):
        return None
    fn = _build.function("dmath_gemm", gemm._ARGTYPES)
    stream = torch.cuda.current_stream().cuda_stream
    calls, keep = [], []
    for a, b in products:
        (M, K), N = a.shape, b.shape[1]
        pl = gemm.plan(M, K, N)
        c = torch.empty((M, N), dtype=a.dtype, device="cuda")
        s = (torch.empty((pl.groups, M, N), dtype=torch.float32,
                         device="cuda") if pl.split > 1 else None)
        keep += [c, s]
        calls.append((a.data_ptr(), 0, b.data_ptr(), 0, c.data_ptr(), 0,
                      s.data_ptr() if s is not None else None, M, N, K, 0,
                      pl.kg, pl.tile_m, 1 if pl.tile_n == 64 else 2,
                      pl.split, int(gemm.uses_tma(a, b)), stream))
    return host_us(lambda *args: _build.check(fn(*args), "matmul"),
                   calls, steps)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="change")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gemm_host_cost: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import Model

    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    cfg = get_config(ARCH)
    D, F, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    q, kv = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    shapes = [(D, q), (D, kv), (D, kv), (q, D), (D, F), (D, F), (F, D)]
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def rand(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    products = [(rand(SLOTS, K), rand(K, N) * 0.05)
                for _ in range(cfg.n_layers) for K, N in shapes]
    products.append((rand(SLOTS, D), rand(D, V) * 0.05))
    out = dict(label=args.label, src=args.src, calls=len(products))
    out["gemm_host_us_per_call"] = host_us(ops.matmul, products, args.steps)
    out["torch_matmul_host_us_per_call"] = host_us(torch.matmul, products,
                                                   args.steps)
    out["gemm_entry_host_us_per_call"] = entry_us(products, args.steps)
    from repro_torch.kernels import gemm
    fake_cls = getattr(gemm, "FakeTensor", None)
    if fake_cls is not None:
        out["fake_test_host_us_per_call"] = host_us(
            lambda a, b: isinstance(a, fake_cls), products, args.steps)
        out["empty_call_host_us_per_call"] = host_us(
            lambda a, b: None, products, args.steps)
    del products

    model = Model(cfg, device="cuda")
    params = model.init(SEED)
    cache = model.init_paged_cache(SLOTS, MAX_SEQ, PAGE)
    rng = np.random.default_rng(SEED + 2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (SLOTS, 1))).cuda()
    pos = torch.from_numpy(rng.integers(64, 576, SLOTS)).cuda()
    for _ in range(3):
        model.decode_step_paged(params, cache, tokens, pos)
    issue, wall = [], []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.decode_step_paged(params, cache, tokens, pos)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        issue.append(1e3 * (t1 - t0))
        wall.append(1e3 * (t2 - t0))
    out["decode_step_host_ms"] = statistics.median(issue)
    out["decode_step_wall_ms"] = statistics.median(wall)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
