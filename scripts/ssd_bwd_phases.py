"""Where the SSD backward's passes spend their time, by phase, on one CUDA
card: ``csrc/ssd_scan_bwd.cu`` built with ``nvcc -DSSD_BWD_PHASES``, which
compiles in its ``PHASE(k)`` marks, into ``build/ssd_bwd_phases/`` and
called through the wrapper in place of the library's entry, at
mamba2-780m's train shape (x (2,512,48,64), B/C (2,512,1,128), no
final-state cotangent), bf16 and fp32.

Thread 0 of every block adds the cycles since its last mark to the
phase the mark closes; the script prints each phase's mean over the
blocks of a kernel (kcycles, and its share of the block's total) after
three calls.  A phase that ends at a barrier includes the wait for the
slowest warp.  ``STATE`` and ``CHUNK`` name the phases that the source's
``PHASE(1)``, ``PHASE(2)``, ... marks close, in order.

    python3 scripts/ssd_bwd_phases.py

Prints the card's name and power limit, the phases and one JSON line.
Exits 1 without a card.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build, ssd_scan  # noqa: E402

SRC = ROOT / "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu"
OUT = ROOT / "build/ssd_bwd_phases"

# The phases each kernel's marks close, PHASE(1) first.
STATE = ["loop top", "wait, convert, sync", "issue", "product", "recurrence"]
CHUNK = ["prologue: C, B, C B^T", "head: first stage wait", "S1 convert",
         "S1 issue", "S1 products", "S2: L, DU o L, M's sums",
         "S2 sync, pass 1 wait, issue", "S3 products (dC, dB)",
         "S4 stage wait", "S4 convert", "S4 issue", "S4 T = B dS^T",
         "S4 du's term from y", "S4 du, dx, dB's state term",
         "row sums, sync", "da, next head's decays"]


def build() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / "libssd_bwd_phases.so"
    r = subprocess.run(
        [_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3", "-Xcompiler",
         "-fPIC", "-shared", "-DSSD_BWD_PHASES", str(SRC), "-o", str(so)],
        capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"ssd_bwd_phases: nvcc failed\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.dmath_ssd_scan_bwd.argtypes = ssd_scan._BWD_ARGTYPES
    lib.dmath_ssd_scan_bwd.restype = ctypes.c_int
    return lib


def inputs(dtype):
    g = torch.Generator(device="cuda").manual_seed(0)
    B, S, H, P, G, N = 2, 512, 48, 64, 1, 128
    r = lambda *s: torch.randn(*s, device="cuda", generator=g)
    dt = torch.empty(B, S, H, device="cuda").uniform_(
        math.log(1e-3), math.log(0.1), generator=g).exp()
    A = -torch.empty(H, device="cuda").uniform_(1, 16, generator=g)
    return (r(B, S, H, P).to(dtype), dt, A, r(B, S, G, N).to(dtype),
            r(B, S, G, N).to(dtype), r(B, S, H, P).to(dtype))


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_bwd_phases: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{smi.strip()}")
    lib = build()
    library = _build.function
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        x, dt, A, Bm, C, dy = inputs(dtype)
        scratch = ssd_scan._forward(x, dt, A, Bm, C, None)[2]
        _build.function = lambda name, argtypes: (
            lib.dmath_ssd_scan_bwd if name == "dmath_ssd_scan_bwd"
            else library(name, argtypes))
        try:
            for _ in range(3):
                lib.dmath_phase_zero()
                ssd_scan.ssd_backward(x, dt, A, Bm, C, dy, None, scratch)
                torch.cuda.synchronize()
        finally:
            _build.function = library
        buf = (ctypes.c_ulonglong * (2 * 4096 * 32))()
        lib.dmath_phase_read(buf)
        key = str(dtype).split(".")[-1]
        for k, marks, name in ((1, STATE, "state pass"),
                               (0, CHUNK, "chunk pass")):
            rows = [[buf[(k * 4096 + bid) * 32 + i] for i in range(32)]
                    for bid in range(4096)]
            rows = [r for r in rows if any(r)]
            total = sum(sum(r) for r in rows) / len(rows)
            phases = {m: sum(r[i] for r in rows) / len(rows) / 1e3
                      for i, m in enumerate(marks, 1)}
            print(f"{key} {name}: {len(rows)} blocks, {total / 1e3:.1f} "
                  "kcycles a block")
            for p, kc in phases.items():
                print(f"   {p:32s} {kc:8.1f} kcycles "
                      f"({100 * kc / (total / 1e3):.1f}%)")
            out[f"{key} {name}"] = dict(blocks=len(rows),
                                        kcycles=total / 1e3, phases=phases)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
