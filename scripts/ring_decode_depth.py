"""How far a windowed model's prefill-then-decode logits drift from its
full-sequence forward over the same tokens, by depth, on the CPU (the
plain versions of the kernels), at gemma3-27b's full width.

The full forward multiplies the MLP's ``act(g) * h`` in fp32 and rounds
once; the decode step takes ``glu_mlp``'s product of the two rounded to
bf16 (both as the reference does), so every decoded token's activations
differ by bf16 roundings in each layer, and the difference grows with
depth.  This prefills a prompt that wraps the local layers' rings (1,040
tokens against gemma3's window of 1,024), decodes ``--decode`` tokens
teacher-forced, and prints how far each step's logits lie from the
forward's at the same position, in fractions of the largest:

    PYTHONPATH=src python3 scripts/ring_decode_depth.py --layers 2 6 12

The vocabulary is cut to ``--vocab`` (32,768 of 262,144 by default) to
keep the embedding and unembedding small on the host; every other width
is the config's.  ``--device cuda`` runs the kernels on the card instead
(``--layers 62 --vocab 262144``: the whole model).  ``--fault`` also
reads the same drift with a planted fault, every ring call's
``seq_lens`` one short (one live slot left unread), to show what a
tolerance on this drift can catch.  Prints one line per depth and one
JSON line.  A numerical difference, not a time.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model  # noqa: E402


@contextlib.contextmanager
def ring_lens_one_short(window: int):
    """The planted fault: each ring call (pages of ``window`` slots) of
    ``ops.paged_decode_attention`` reads one live slot fewer."""
    kernel = ops.paged_decode_attention

    def faulty(q, k_pages, v_pages, table, seq_lens, **kw):
        if k_pages.shape[1] == window:
            seq_lens = seq_lens - 1
        return kernel(q, k_pages, v_pages, table, seq_lens, **kw)

    ops.paged_decode_attention = faulty
    try:
        yield
    finally:
        ops.paged_decode_attention = kernel


def drift(model, params, tokens: torch.Tensor, prompt: int):
    """(decode-step logits, forward logits) at positions prompt.. of
    ``tokens`` (1, S): the prompt prefilled into a one-slot cache, then
    one decode step per later token."""
    S = tokens.shape[1]
    with torch.no_grad():
        cache = model.init_cache(1, S)
        model.prefill(params, tokens[:, :prompt], cache=cache, slot=0)
        steps = []
        for p in range(prompt, S):
            logits, _ = model.decode_step(
                params, cache, tokens[:, p:p + 1],
                torch.tensor([p], device=tokens.device))
            steps.append(logits[0, 0])
        x, _ = model._dense_stack(params, tokens)
        full = model._head(params, x[:, prompt:])[0]
    return torch.stack(steps).float().cpu(), full.float().cpu()


def reading(dec, full) -> dict:
    return dict(max_abs_diff_frac=float((dec - full).abs().max()
                                        / full.abs().max()),
                rel_rms=float((dec - full).norm() / full.norm()),
                greedy_equal=bool((dec.argmax(-1) == full.argmax(-1)).all()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-27b")
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 6, 12])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt", type=int, default=1040)
    ap.add_argument("--decode", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--fault", action="store_true")
    args = ap.parse_args()
    base = get_config(args.arch)
    vocab = min(args.vocab, base.vocab_size)
    tokens = torch.from_numpy(np.random.default_rng(args.seed + 1).integers(
        0, vocab, (1, args.prompt + args.decode))).to(args.device)
    out = {}
    for L in args.layers:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(base, n_layers=L, vocab_size=vocab)
        model = Model(cfg, device=args.device)
        params = model.init(args.seed)
        out[L] = reading(*drift(model, params, tokens, args.prompt))
        if args.fault:
            with ring_lens_one_short(cfg.window):
                out[L]["fault"] = reading(*drift(model, params, tokens,
                                                 args.prompt))
        for what, r in ((f"{L} layers", out[L]),
                        (f"{L} layers, planted fault", out[L].get("fault"))):
            if r:
                print(f"{what}: decode vs forward logits differ by "
                      f"{r['max_abs_diff_frac']:.3%} of the largest, "
                      f"relative rms {r['rel_rms']:.3%}, greedy equal "
                      f"{r['greedy_equal']}", flush=True)
        print(f"({time.perf_counter() - t0:.0f} s)", flush=True)
        del model, params
    print(json.dumps({"decode_vs_forward": out, "arch": args.arch,
                      "vocab": vocab, "prompt": args.prompt,
                      "decode": args.decode, "device": args.device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
