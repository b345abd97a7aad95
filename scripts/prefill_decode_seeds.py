"""Run ``chip_smoke.py``'s mamba2-780m prefill-then-decode comparison
(``prefill_then_decode``: prefill 299 tokens, decode the 300th, against
the full forward on 300) at full width over several seeds, on one CUDA
card, and report each state's drift from the forward against
``chip_smoke.STATE_TOL``.  Seed s draws the weights from s and the
tokens from s + 4, so seed 0 is ``chip_smoke.py``'s own case.

``--root`` names the checkout (default: this one), so two versions of
the SSD kernel, for example one unpacked under ``build/``, are compared
by the same seeds on one machine:

    python3 scripts/prefill_decode_seeds.py --seeds 16
    python3 scripts/prefill_decode_seeds.py --root build/variant --seeds 16

Prints the card's name and power limit, a line per seed and one JSON
line.  Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--seeds", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("prefill_decode_seeds: no CUDA device", file=sys.stderr)
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
    t0 = time.perf_counter()
    _build.build()
    out = dict(root=str(root), device=smi, build_s=time.perf_counter() - t0,
               state_tol=cs.STATE_TOL, seeds=[])
    cfg = get_config(cs.MAMBA)
    model = cs.Model(cfg, device="cuda")
    for seed in range(args.seeds):
        params = model.init(seed)
        got, want, drift, control, _ = cs.prefill_then_decode(
            cfg, model, params, seed=seed + 4)
        logits = float((got - want).abs().max() / want.abs().max())
        row = dict(seed=seed, logits=logits, control_ssm=control,
                   within=all(d <= cs.STATE_TOL for d in drift.values()),
                   **drift)
        print(json.dumps(row), flush=True)
        out["seeds"].append(row)
        del params
    out["within"] = sum(r["within"] for r in out["seeds"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
