"""Time the flash-attention kernels of a checkout on one CUDA card, by
``chip_smoke.py``'s own checks (``check_flash`` and
``check_attention_backward`` of that checkout): each prefill chunk of a
512-token prompt at qwen2-0.5b's heads, and the backward (with the
forward that keeps its log-sum-exp) at the train shape, beside their
bounds, plain versions and library calls, each held against its plain
version.

``--root`` names the checkout (default: this one), so two versions, for
example the parent commit unpacked with ``git archive`` under ``build/``,
are timed by their own code on one machine.  Interleave them:

    python3 scripts/flash_attention_time.py --root build/parent
    python3 scripts/flash_attention_time.py
    python3 scripts/flash_attention_time.py
    python3 scripts/flash_attention_time.py --root build/parent

Each run prints the card's name and power limit, the checks' table rows
and one JSON line.  Exits 1 without a card.
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_attention_time: no CUDA device", file=sys.stderr)
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
    out = dict(root=str(root), build_s=time.perf_counter() - t0)
    cfg = get_config(cs.ARCH)
    fwd = cs.check_flash(cfg)
    bwd = cs.check_attention_backward(cfg)
    out["prefill_chunk_ms"] = fwd["ms"]
    out["prefill_chunk_library_ms"] = fwd["library_ms"]
    out.update({f"backward_{k}": v for k, v in bwd.items()
                if isinstance(v, (int, float, dict))})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
