"""Reproducibility: master-distributed seeds (paper §2.3), ported from the
reference's ``core/rng.py``.

dMath distributes seed values from the master node to workers so runs
are reproducible, while documenting the few subroutines whose reduction
order is non-deterministic.  The reference derives a subkey from a root
``PRNGKey`` along a *named path* (``fold_in`` per part), so any rank
derives the same stream without communication.

:func:`root_key` and :func:`derive` give the reference's keys bit for bit:
a ``uint32`` pair, folded by threefry2x32 (20 rounds, JAX's default PRNG)
on int64 tensors kept to 32 bits, string parts hashed with blake2s as the
reference hashes them.  :func:`generator` turns a key into a
``torch.Generator``; its draws are PyTorch's, not JAX's bits (a
deliberate deviation: the port's weights draw from ``torch.Generator``s).
"""

from __future__ import annotations

import hashlib
from typing import Union

import torch

PathPart = Union[str, int]
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def root_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as the reference runs it (32-bit JAX):
    ``[0, seed mod 2**32]``."""
    return torch.tensor([0, seed & _M32], dtype=torch.int64).to(torch.uint32)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(key: torch.Tensor, x0: int, x1: int) -> torch.Tensor:
    """Threefry-2x32 of the counter pair (x0, x1) under ``key``."""
    k = key.to(torch.int64)
    ks = (k[0], k[1], k[0] ^ k[1] ^ 0x1BD11BDA)
    x = [(torch.tensor(x0, dtype=torch.int64) + ks[0]) & _M32,
         (torch.tensor(x1, dtype=torch.int64) + ks[1]) & _M32]
    for i in range(5):
        for rot in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], rot) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return torch.stack(x).to(torch.uint32)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: threefry of the counter ``(0, data)``."""
    return threefry2x32(key, 0, int(data) & _M32)


def _fold_str(key: torch.Tensor, s: str) -> torch.Tensor:
    h = int.from_bytes(hashlib.blake2s(s.encode(), digest_size=4).digest(),
                       "little")
    return fold_in(key, h)


def derive(key: torch.Tensor, *path: PathPart) -> torch.Tensor:
    """A deterministic subkey along a hierarchical path:
    ``derive(k, "layer", 3, "dropout")`` is the same on every rank, mesh
    and restart (the path *is* the metadata)."""
    for p in path:
        key = _fold_str(key, p) if isinstance(p, str) else fold_in(key, p)
    return key


def per_step(key: torch.Tensor, step: int) -> torch.Tensor:
    return fold_in(key, step)


def generator(key: torch.Tensor,
              device: Union[str, torch.device] = "cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded by the key's 64 bits."""
    k = key.to(torch.int64)
    return torch.Generator(device=device).manual_seed(
        (int(k[0]) << 32) | int(k[1]))


# Subroutines whose distributed reduction order is allowed to be
# non-deterministic for speed (paper §2.3 names AddRowColSumMatrix).  Each
# entry maps name -> why.  Everything NOT listed here must be bitwise
# reproducible given the same mesh.
NONDETERMINISTIC_OPS = {
    "grad_allreduce_compressed": "error-feedback quantization reduces in ring order",
    "add_row_col_sum_matrix[fast]": "bf16 cross-shard colsum, runtime "
                                    "reduction order (the paper's own §2.3 example)",
}
