"""How far the dense and the paged prefill's logits differ at qwen2-0.5b's
full width, by depth, on the CPU (the plain versions of the kernels).

The dense prefill runs the full-sequence forward, whose MLP multiplies
``act(g) * h`` in fp32 and rounds once; the paged prefill chunk takes
``glu_mlp``'s product of the two rounded to bf16 (both as the reference
does).  The two differ by bf16 roundings in every layer, and this prints
how that difference in the last position's logits grows with the number
of layers, from random weights drawn from ``--seed`` and a 64-token
prompt:

    PYTHONPATH=src python3 scripts/dense_paged_depth.py --layers 2 6 12 24

Prints one line per depth and one JSON line.  A CPU run: a numerical
difference, not a device metric.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 6, 12, 24])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt", type=int, default=64)
    args = ap.parse_args()
    base = get_config("qwen2-0.5b")
    prompt = torch.from_numpy(np.random.default_rng(args.seed + 1).integers(
        0, base.vocab_size, (1, args.prompt)))
    out = {}
    for L in args.layers:
        model = Model(dataclasses.replace(base, n_layers=L), device="cpu")
        params = model.init(args.seed)
        with torch.no_grad():
            dense, _ = model.prefill(params, prompt)
            cache = model.init_paged_cache(1, args.prompt, args.prompt)
            paged, _ = model.prefill_chunk_paged(params, cache, prompt,
                                                 cache["table"][0], 0)
        d, p = dense[0, -1], paged[0, -1]
        frac = float((d - p).abs().max() / p.abs().max())
        rel_rms = float((d - p).norm() / p.norm())
        out[L] = dict(max_abs_diff_frac=frac, rel_rms=rel_rms,
                      greedy_equal=bool(d.argmax() == p.argmax()))
        print(f"{L} layers: dense vs paged prefill logits differ by "
              f"{frac:.3%} of the largest, relative rms {rel_rms:.3%}",
              flush=True)
    print(json.dumps({"dense_vs_paged_prefill": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
