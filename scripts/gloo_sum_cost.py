"""Two ways to sum floating gradients over a gloo group of two ranks that
share one CUDA card, as the train and compressed-DP phases of
``chip_smoke.py`` run them, timed on qwen2-0.5b's 15 gradient leaves
(630,167,424 elements, each reduced on its own as ``compressed_psum``
does):

- ``backend``: ``torch.distributed.all_reduce`` on a clone (gloo's ring,
  whose adds start each chunk at another rank), which the port's
  ``schedules.all_reduce`` runs for a floating sum over two ranks;
- ``ordered``: ``schedules.ordered_sum``, an all_gather and adds in rank
  order (the reference's bits at any group size), which it runs from
  three ranks on.

For fp32 and bf16 leaves, the two run interleaved (backend, ordered,
ordered, backend, twice).  Rank 0 prints the card's name and power
limit, then one JSON line per dtype: ms per pass over the 15 leaves
(each pass ended by a synchronize), the peak device memory per rank above
the leaves, and whether the two sums gave the same bits (two addends
commute, so they must).

    python3 scripts/gloo_sum_cost.py

Exits 1 without a card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
RDZV = ROOT / "build" / "gloo_sum_cost"
SEED, RANKS = 0, 2


def leaf_shapes():
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    specs = Model(get_config("qwen2-0.5b"), device="cpu").param_specs()
    return [tuple(s.shape) for s in specs.values()]


def rank_main(rank: int, init: str, shapes) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.comms import schedules
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, world_size=RANKS,
                            rank=rank)

    def backend(x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    ways = dict(backend=backend, ordered=schedules.ordered_sum)
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device="cuda").manual_seed(SEED + rank)
        leaves = [torch.randn(s, generator=g, device="cuda").to(dtype)
                  for s in shapes]
        same = all(torch.equal(backend(x), schedules.ordered_sum(x))
                   for x in leaves)
        ms = {k: [] for k in ways}
        peak = {k: 0.0 for k in ways}
        for name in ("backend", "ordered", "ordered", "backend") * 2:
            torch.cuda.synchronize()
            dist.barrier()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for x in leaves:
                ways[name](x)
            torch.cuda.synchronize()
            ms[name].append(1e3 * (time.perf_counter() - t0))
            peak[name] = max(peak[name], (torch.cuda.max_memory_allocated()
                                          - base) / 2**30)
        if rank == 0:
            print(json.dumps(dict(
                dtype=str(dtype), ranks=RANKS, leaves=len(leaves),
                elements=sum(x.numel() for x in leaves),
                same_bits=same, ms_per_pass=ms,
                ms_median={k: statistics.median(v) for k, v in ms.items()},
                peak_gib_above_leaves=peak)), flush=True)
        del leaves
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_sum_cost: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    RDZV.mkdir(parents=True, exist_ok=True)
    rdzv = RDZV / "rendezvous"
    rdzv.unlink(missing_ok=True)
    try:
        mp.spawn(rank_main, args=(f"file://{rdzv}", leaf_shapes()),
                 nprocs=RANKS, join=True)
    finally:
        rdzv.unlink(missing_ok=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
