"""Serving driver: ``python -m repro_torch.launch.serve --arch <id> [...]``.

A thin CLI over :class:`repro_torch.api.Session`, as the reference's:
``Session.plan`` (decode kind) -> ``Session.serve`` (the engine on the
session's persistent params, random from ``--seed``, and its KV cache,
the steps from the session's compiled-artifact cache); feeds synthetic
prompts and reports tokens/s.  ``--scheduler static`` (the
default) runs the fixed-slot engine on the model's dense cache, the
reference's default for every family (qwen2's KV cache, mamba2's
states), or on the paged cache with ``--paged``; ``--scheduler
continuous`` runs continuous batching over the paged block pool.
``--prompt-len N`` gives every prompt N tokens, ``LO:HI`` draws each
length from [LO, HI].  ``--metrics PATH`` streams the engine's spans and
latency histograms as JSONL to PATH, prints their p50/p99 and writes a
``BENCH_serve_metrics.json`` snapshot beside PATH.  Runs on the card
unless ``--device cpu`` is given; ``--scale-down 1`` keeps the published
width.  ``run(mesh=)`` serves on a mesh (the reference's): every rank of
the mesh's process group calls it, each holding its blocks of the params
and its shard of the KV cache, and prints the same tokens.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch.api import Session
from repro_torch.core.device import resolve_device
from repro_torch.serve import Request


def run(arch: str, *, n_requests: int = 8, batch_slots: int = 4,
        max_seq: int = 128, prompt_len: Union[int, Tuple[int, int]] = 16,
        new_tokens: int = 16, scale_down: int = 64, seed: int = 0,
        metrics: Optional[str] = None, paged: bool = False,
        page_size: int = 64, scheduler: str = "static",
        prefill_chunk: int = 32, num_pages: Optional[int] = None,
        device: str = "cuda", mesh=None):
    dev = resolve_device(device)
    # --metrics: stream spans + per-request prefill/decode latency
    # histograms as JSONL; off -> NULL obs, output unchanged
    obs = obs_mod.Obs(jsonl=metrics, name=f"serve/{arch}") if metrics \
        else obs_mod.NULL
    prev_obs = obs_mod.set_active(obs)
    try:
        return _run(arch, obs, dev, n_requests=n_requests,
                    batch_slots=batch_slots, max_seq=max_seq,
                    prompt_len=prompt_len, new_tokens=new_tokens,
                    scale_down=scale_down, seed=seed, metrics=metrics,
                    paged=paged, page_size=page_size, scheduler=scheduler,
                    prefill_chunk=prefill_chunk, num_pages=num_pages,
                    mesh=mesh)
    finally:
        obs_mod.set_active(prev_obs)
        obs.close()


def _run(arch, obs, dev, *, n_requests, batch_slots, max_seq, prompt_len,
         new_tokens, scale_down, seed, metrics, paged, page_size, scheduler,
         prefill_chunk, num_pages, mesh):
    session = Session(device=dev, mesh=mesh)
    plan = session.plan(arch, batch=batch_slots, seq=max_seq, kind="decode",
                        scale_down=scale_down)
    cfg = plan.cfg
    # the stream holds the engine's spans and histograms only (the plan's
    # event is left out of it)
    session.obs = obs
    with obs.span("build_engine", arch=arch, scheduler=scheduler):
        eng = session.serve(plan, batch_slots=batch_slots, max_seq=max_seq,
                            seed=seed, paged=paged, page_size=page_size,
                            scheduler=scheduler, prefill_chunk=prefill_chunk,
                            num_pages=num_pages)
    rng = np.random.default_rng(seed)
    lo, hi = (prompt_len, prompt_len) if isinstance(prompt_len, int) \
        else prompt_len
    lens = (rng.integers(lo, hi + 1, n_requests) if hi > lo
            else [lo] * n_requests)
    for rid, n in enumerate(lens):
        eng.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size, int(n), dtype=np.int32),
            max_new_tokens=new_tokens))
    t0 = time.perf_counter()
    total = 0
    ticks = 0
    with obs.span("serve", requests=n_requests):
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
    if obs.enabled:
        session.publish_metrics()
        for name in ("serve.prefill_s", "serve.decode_s", "serve.ttft_s",
                     "serve.queue_wait_s"):
            s = obs.histogram(name).summary()
            if s.get("count"):
                print(f"{name}: n={s['count']} p50={s['p50'] * 1e3:.1f}ms "
                      f"p99={s['p99'] * 1e3:.1f}ms")
        snap = os.path.join(os.path.dirname(os.path.abspath(metrics)) or ".",
                            "BENCH_serve_metrics.json")
        serve_meta = {
            "scheduler": scheduler,
            "paged": bool(paged or scheduler == "continuous"),
            "page_size": page_size, "prefill_chunk": prefill_chunk,
            "preemptions": obs.counter("serve.preemptions").value,
            "refusals": len(getattr(eng, "refused", ())),
        }
        if hasattr(eng, "blocks"):
            serve_meta["pool_pages"] = eng.blocks.num_pages
            serve_meta["pool_pages_used"] = eng.blocks.used_pages
        obs.snapshot(snap, arch=arch, requests=n_requests,
                     tokens=total, tok_per_s=total / dt, seconds=dt,
                     device=str(dev), serve=serve_meta)
        print(f"metrics: {metrics}  snapshot: {snap}")
    return total, dt


def _prompt_len(text: str) -> Union[int, Tuple[int, int]]:
    if ":" in text:
        lo, hi = (int(v) for v in text.split(":"))
        if not 0 < lo <= hi:
            raise argparse.ArgumentTypeError(f"bad range {text!r}")
        return lo, hi
    return int(text)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--prompt-len", type=_prompt_len, default=16,
                    help="prompt tokens: N, or LO:HI for lengths drawn "
                         "uniformly from [LO, HI]")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--scale-down", type=int, default=64)
    ap.add_argument("--scheduler", choices=("static", "continuous"),
                    default="static",
                    help="static fixed-slot engine (default) or continuous "
                         "batching over the paged block pool")
    ap.add_argument("--paged", action="store_true",
                    help="block-paged KV cache for the static engine "
                         "(plain-attention archs)")
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prefill chunk tokens (paged/continuous paths); "
                         "must divide the table row (max-seq rounded up "
                         "to a page)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="continuous pool pages incl. the NULL page "
                         "(default: full static capacity)")
    ap.add_argument("--metrics", type=str, default=None, metavar="PATH",
                    help="write a JSONL telemetry stream (spans, prefill/"
                         "decode latency histograms) to PATH and a "
                         "BENCH_serve_metrics.json snapshot beside it; "
                         "default off")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args()
    run(args.arch, n_requests=args.requests, batch_slots=args.batch_slots,
        max_seq=args.max_seq, prompt_len=args.prompt_len,
        new_tokens=args.new_tokens, scale_down=args.scale_down,
        seed=args.seed, metrics=args.metrics, paged=args.paged,
        page_size=args.page_size, scheduler=args.scheduler,
        prefill_chunk=args.prefill_chunk, num_pages=args.num_pages,
        device=args.device)


if __name__ == "__main__":
    main()
