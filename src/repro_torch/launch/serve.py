"""Serving driver: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Builds the model with random weights from ``--seed`` and a serve engine
directly (the reference goes through ``Session``, which a later slice
ports), feeds synthetic prompts and reports tokens/s.  ``--scheduler
continuous`` runs continuous batching over the paged block pool;
``--scheduler static`` runs the fixed-slot engine on the model's dense
cache (the ssm family, e.g. ``--arch mamba2-780m``), or on the paged cache
with ``--paged`` (the dense family).  Runs on the card unless ``--device
cpu`` is given; ``--scale-down 1`` keeps the published width.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config, scale_config
from repro_torch.core.device import resolve_device
from repro_torch.models import Model
from repro_torch.serve import ContinuousEngine, Engine, Request


def run(arch: str, *, n_requests: int = 8, batch_slots: int = 4,
        max_seq: int = 128, prompt_len: int = 16, new_tokens: int = 16,
        scale_down: int = 64, seed: int = 0, paged: bool = False,
        page_size: int = 64, scheduler: str = "static",
        prefill_chunk: int = 32, num_pages: Optional[int] = None,
        device: str = "cuda"):
    dev = resolve_device(device)
    cfg = scale_config(get_config(arch), scale_down)
    model = Model(cfg, device=dev)
    params = model.init(seed)
    if scheduler == "continuous":
        eng = ContinuousEngine(model, params, batch_slots=batch_slots,
                               max_seq=max_seq, seed=seed,
                               page_size=page_size, num_pages=num_pages,
                               prefill_chunk=prefill_chunk)
    else:
        eng = Engine(model, params, batch_slots=batch_slots,
                     max_seq=max_seq, seed=seed, paged=paged,
                     page_size=page_size, prefill_chunk=prefill_chunk)
    rng = np.random.default_rng(seed)
    for rid in range(n_requests):
        eng.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size, prompt_len,
                                dtype=np.int32),
            max_new_tokens=new_tokens))
    t0 = time.perf_counter()
    total = 0
    ticks = 0
    while (eng.queue or any(r is not None for r in eng.active)) \
            and ticks < 10_000:
        total += eng.step()
        ticks += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"{arch}: {n_requests} requests ({len(eng.finished)} finished), "
          f"{total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s, "
          f"{ticks} ticks) on {dev}")
    return total, dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--scale-down", type=int, default=64)
    ap.add_argument("--scheduler", choices=("static", "continuous"),
                    default="static",
                    help="static fixed-slot engine (default) or continuous "
                         "batching over the paged block pool")
    ap.add_argument("--paged", action="store_true",
                    help="block-paged KV cache for the static engine")
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prefill chunk tokens; must divide the table row "
                         "(max-seq rounded up to a page)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="continuous pool pages incl. the NULL page "
                         "(default: full static capacity)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args()
    run(args.arch, n_requests=args.requests, batch_slots=args.batch_slots,
        max_seq=args.max_seq, new_tokens=args.new_tokens,
        scale_down=args.scale_down, seed=args.seed, paged=args.paged,
        page_size=args.page_size, scheduler=args.scheduler,
        prefill_chunk=args.prefill_chunk, num_pages=args.num_pages,
        device=args.device)


if __name__ == "__main__":
    main()
