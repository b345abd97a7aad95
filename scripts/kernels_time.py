"""Time kernels of a checkout on one CUDA card by ``chip_smoke.py``'s own
checks of that checkout: each ``--check`` names one (``check_flash``,
``check_attention_backward``, ``check_paged``, ``check_ssd``, ...), which
holds its kernel against the plain version at the serve or train path's
shapes and times it beside its bound, plain version and library call.
``--decode-step`` adds the device µs by kernel of one qwen2-0.5b decode
step at full width (8 slots at serve-like positions, as ``chip_smoke.py``
builds it), profiled over 10 eager steps.

``--root`` names the checkout (default: this one), so two versions, for
example the parent commit unpacked with ``git archive`` under ``build/``,
are timed by their own code on one machine.  Interleave them:

    for r in build/parent . . build/parent; do
        python3 scripts/kernels_time.py --root $r \\
            --check check_paged --check check_ssd --decode-step; done

Each run prints the card's name and power limit, the checks' lines and
one JSON line.  Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def decode_step_us(cs, cfg):
    """Device µs by kernel of one decode step of the checkout's qwen2
    model at full width (``chip_smoke.step_breakdown``'s step)."""
    model = cs.Model(cfg, device="cuda")
    params = model.init(cs.SEED)
    cache = model.init_paged_cache(cs.SLOTS, cs.MAX_SEQ, cs.PAGE)
    rng = np.random.default_rng(cs.SEED + 2)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (cs.SLOTS, 1))).cuda()
    pos = torch.from_numpy(rng.integers(
        cs.PROMPT_MIN, cs.PROMPT_MAX + cs.NEW_TOKENS, cs.SLOTS)).cuda()
    us = cs.kernel_us(
        lambda: model.decode_step_paged(params, cache, tokens, pos),
        calls=10)
    print(f"decode step, positions {pos.tolist()}: device µs by kernel "
          f"{us}", flush=True)
    return dict(positions=pos.tolist(), kernel_us=us)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--check", action="append", default=[],
                    help="a check of the checkout's chip_smoke.py")
    ap.add_argument("--decode-step", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernels_time: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    os.chdir(root)
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    out = dict(root=str(root), device=smi, build_s=time.perf_counter() - t0)
    cfg = get_config(cs.ARCH)
    for name in args.check:
        fn = getattr(cs, name)
        out[name] = fn(cfg) if inspect.signature(fn).parameters else fn()
    if args.decode_step:
        out["decode_step"] = decode_step_us(cs, cfg)
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
