#!/usr/bin/env python3
"""Which ``torch.distributed`` collectives a gloo group runs on CUDA
tensors, in fp32 and bf16: ``python3 scripts/gloo_cuda_coverage.py
[--ranks 4]`` on a machine with a card (every rank on ``cuda:0``, a
``file://`` rendezvous under ``build/gloo_cuda_coverage/``).

Each rank tries each call on a small tensor and checks its values; rank 0
prints one JSON object, ``{call: {dtype: "ok" | "wrong values" |
error}}``.  ``batch_isend_irecv`` comes last, as a ring: a backend that
reads a device pointer from the host can end the process there, which
the parent reports (every rank is a subprocess with a time limit).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "build" / "gloo_cuda_coverage"

RANK = r"""
import json, sys
import torch
import torch.distributed as dist
rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
dev = torch.device("cuda:0")
res = {}

def mine(dtype, n=8):
    return (torch.arange(n, device=dev, dtype=torch.float32) + 100 * rank).to(dtype)

def full(dtype, n=8):
    return torch.cat([(torch.arange(n, device=dev, dtype=torch.float32) + 100 * r)
                      for r in range(world)]).to(dtype)

def all_gather(dtype):
    parts = [torch.empty(8, device=dev, dtype=dtype) for _ in range(world)]
    dist.all_gather(parts, mine(dtype))
    return torch.equal(torch.cat(parts), full(dtype))

def all_gather_into_tensor(dtype):
    out = torch.empty(8 * world, device=dev, dtype=dtype)
    dist.all_gather_into_tensor(out, mine(dtype))
    return torch.equal(out, full(dtype))

def all_to_all_single(dtype):
    x = mine(dtype, 2 * world)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x)
    want = torch.cat([(torch.arange(2 * world, device=dev, dtype=torch.float32)
                       + 100 * r)[2 * rank:2 * rank + 2] for r in range(world)])
    return torch.equal(out, want.to(dtype))

def all_reduce(dtype):
    x = mine(dtype)
    dist.all_reduce(x)
    want = sum(torch.arange(8, device=dev, dtype=torch.float32) + 100 * r
               for r in range(world))
    return torch.equal(x, want.to(dtype))

def reduce_scatter_tensor(dtype):
    x = mine(dtype, 2 * world)
    out = torch.empty(2, device=dev, dtype=dtype)
    dist.reduce_scatter_tensor(out, x)
    want = sum((torch.arange(2 * world, device=dev, dtype=torch.float32)
                + 100 * r)[2 * rank:2 * rank + 2] for r in range(world))
    return torch.equal(out, want.to(dtype))

def reduce_scatter(dtype):
    x = mine(dtype, 2 * world)
    out = torch.empty(2, device=dev, dtype=dtype)
    dist.reduce_scatter(out, list(x.chunk(world)))
    want = sum((torch.arange(2 * world, device=dev, dtype=torch.float32)
                + 100 * r)[2 * rank:2 * rank + 2] for r in range(world))
    return torch.equal(out, want.to(dtype))

def batch_isend_irecv(dtype):
    x = mine(dtype)
    got = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, (rank + 1) % world),
           dist.P2POp(dist.irecv, got, (rank - 1) % world)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return torch.equal(got, (torch.arange(8, device=dev, dtype=torch.float32)
                             + 100 * ((rank - 1) % world)).to(dtype))

for fn in (all_gather, all_gather_into_tensor, all_to_all_single, all_reduce,
           reduce_scatter_tensor, reduce_scatter, batch_isend_irecv):
    res[fn.__name__] = {}
    for dtype in (torch.float32, torch.bfloat16):
        try:
            ok = fn(dtype)
            torch.cuda.synchronize()
            res[fn.__name__][str(dtype)] = "ok" if ok else "wrong values"
        except Exception as e:  # the backend refuses: record its message
            res[fn.__name__][str(dtype)] = f"{type(e).__name__}: {e}"[:200]
        dist.barrier()
        with open(out, "w") as f:
            json.dump(res, f)
dist.destroy_process_group()
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args()
    WORK.mkdir(parents=True, exist_ok=True)
    (WORK / "rendezvous").unlink(missing_ok=True)
    init = f"file://{WORK / 'rendezvous'}"
    outs = [WORK / f"rank{r}.json" for r in range(args.ranks)]
    for f in outs:
        f.unlink(missing_ok=True)
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r),
                               str(args.ranks), init, str(outs[r])])
             for r in range(args.ranks)]
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=240))
        except subprocess.TimeoutExpired:
            p.kill()
            rcs.append("timeout")
    for p in procs:
        if p.poll() is None:
            p.kill()
    res = json.loads(outs[0].read_text()) if outs[0].exists() else {}
    import torch
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "rank_exit_codes": rcs, "calls": res}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
