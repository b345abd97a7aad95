"""Batched serving engines, ported from the reference's
``serve/engine.py``.

- :class:`Engine` — static batching: fixed slots, finished slots refilled
  from the queue, every slot decoding at its own position.  As in the
  reference, it holds the model's dense cache by default
  (``paged=False``: ``Model.init_cache``, each prompt prefilled in one
  B = 1 pass at its exact length and written into its slot's row, then
  ``Model.decode_step`` over all slots; the dense family's step attends
  through the paged-decode kernel with each slot's row as one page, under
  a (B, 1) table the engine makes once; a windowed config's local layers
  and the hybrid's sites the same way on their rings and K/V);
  ``paged=True`` gives each slot a slot-major row of pages and prefills
  prompts chunk by chunk, and refuses a windowed config and the ssm and
  hybrid families, as the reference's does.  A vlm is served as text, as
  the reference's engines serve it (``prefill`` without a prefix).
- :class:`ContinuousEngine` — continuous batching: per-tick admission
  through the budget-governed :class:`~repro_torch.serve.scheduler.Scheduler`,
  one prefill chunk per tick for every mid-prefill sequence, lazy page
  growth with preempt-and-requeue, and page recycling.

The paged static engine and the continuous one run the same model steps
(``Model.prefill_chunk_paged`` and ``Model.decode_step_paged``), and
attention gathers pages in logical order, so their greedy outputs are
identical whatever physical pages the allocator hands out.  The model
steps update the caches in place; nothing crosses to the host per token
but the sampled ids.  Greedy sampling is an ``argmax`` on the device;
temperature sampling draws from an explicit ``torch.Generator``.

On a mesh (a ``Model`` built on one, the dense family) both engines run
over it: every rank runs the same ticks on the same requests, the model
steps take this rank's rows and its shard of the KV cache or page pool,
and their logits are whole and the same bits on every rank, so the
greedy tokens are the same without a broadcast (temperature sampling
draws from each rank's generator, seeded alike).  The block manager's
accounting stays global (its pages are the pool's, sharded by page over
the ranks), as in the reference.  The static engine's one-slot prefill
runs on every rank whether or not the batch of one splits over ``data``
(the reference's raises there).

The Session's arguments, as in the reference: ``opcache`` (an
:class:`~repro_torch.core.opcache.OpCache`) hands out the prefill and
decode step callables under the reference's ops and keys, so a second
engine on the same model and shapes reuses them (the port runs eagerly:
an entry is the model's step, built once); ``registry`` (a
:class:`~repro_torch.api.state.StateRegistry`) with ``cache_key`` holds
the engine's KV cache (static) or page pool and table (continuous) as
one entry accounted against the session's budget.  The entry's
stand-in (``meta`` tensors of the same shapes) is put first, so a cache
that does not fit raises :class:`~repro_torch.api.errors.PlanMemoryError`
before anything is allocated; the continuous pool's default size is
clamped to the registry's headroom
(:func:`~repro_torch.serve.blocks.pool_pages_for_budget`).  The steps
update the cache in place, so the entry never needs refreshing.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs as obs_mod

from .blocks import (NULL_PAGE, BlockManager, PoolExhausted,
                     pool_pages_for_budget)
from .scheduler import DeadlineExceeded, Request, Scheduler

__all__ = ["Engine", "ContinuousEngine", "Request"]


def _check_chunking(max_seq: int, page_size: int, chunk: int) -> None:
    """Every prefill chunk must end inside its table row (the row holds
    ``ceil(max_seq / page_size)`` pages), which holds for every prompt
    exactly when the chunk size divides the row length."""
    row = -(-max_seq // page_size) * page_size
    if row % chunk:
        raise ValueError(f"prefill_chunk {chunk} does not divide the table "
                         f"row of {row} positions (max_seq {max_seq}, "
                         f"page {page_size})")


def _check_positions(pos: np.ndarray, limit: int) -> None:
    """The decode contract, checked where the host holds ``pos``:
    ``0 <= pos < limit``, so on the paged cache ``seq_lens = pos + 1 >= 1``
    and the new token's page lies inside its table row."""
    if pos.size and (pos.min() < 0 or pos.max() >= limit):
        raise ValueError(f"decode positions {pos.tolist()} outside "
                         f"[0, {limit})")


def _make_prefill_fn(model):
    """Prefill one request into cache row ``slot`` (a B = 1 forward),
    returning the last position's logits.  A free function closing over
    the model only, as the reference's: the cached step may outlive its
    engine in a Session's op cache."""

    def prefill_slot(params, cache, tokens, slot):
        logits, cache = model.prefill(params, tokens, cache=cache, slot=slot)
        return logits[:, -1, :], cache

    return prefill_slot


def _cached(opcache, model, op, build, **static):
    """``build()``, or the op cache's entry for ``op`` on this model at
    these shapes (the reference's key)."""
    if opcache is None:
        return build()
    mesh = getattr(model, "mesh", None)
    key = opcache.key_for(op, (), mesh_shape=(
        tuple(mesh.shape.items()) if hasattr(mesh, "shape") else ()),
        model=id(model), **static)
    return opcache.get_or_build(key, op, build)


def _resident(registry, cache_key, make):
    """The cache ``make(device)`` builds, held in ``registry`` under
    ``cache_key`` when one is given: its ``meta`` stand-in is put first,
    so an entry over the budget raises before the allocation."""
    if registry is None or cache_key is None:
        return make(None)
    registry.put(cache_key, make("meta"), kind="kv_cache")
    cache = make(None)
    registry.replace_value(cache_key, cache)
    return cache


def _retire(engine, b: int) -> Request:
    """The retirement path, shared by both engines: release the slot's
    storage, stamp the request, collect it on ``engine.finished``."""
    req = engine.active[b]
    engine._release_slot(req, b)
    req.done = True
    req.finish_t = time.perf_counter()
    engine.finished.append(req)
    engine.active[b] = None
    engine.pos[b] = 0
    engine.obs.counter("serve.retired").inc()
    return req


class _Sampler:
    """Greedy argmax on the device, or temperature sampling from an
    explicit generator seeded once per engine."""

    def __init__(self, temperature: float, seed: int, device: torch.device):
        self.temperature = temperature
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def __call__(self, logits: torch.Tensor) -> np.ndarray:
        if self.temperature == 0.0:
            return torch.argmax(logits, -1).cpu().numpy()
        probs = torch.softmax(logits.float() / self.temperature, -1)
        return torch.multinomial(probs, 1, generator=self.gen)[:, 0] \
            .cpu().numpy()


def _sync(obs, device: torch.device) -> None:
    if obs.enabled and device.type == "cuda":
        torch.cuda.synchronize(device)


class Engine:
    """Static-batch engine: fixed slots, per-slot positions, on the dense
    cache (default) or the paged one (``paged=True``)."""

    def __init__(self, model, params, batch_slots: int, max_seq: int,
                 temperature: float = 0.0, seed: int = 0,
                 opcache=None, registry=None, cache_key: str = None,
                 obs=None, paged: bool = False, page_size: int = 64,
                 prefill_chunk: int = 32):
        self.obs = obs if obs is not None else obs_mod.NULL
        self.model = model
        self.params = params
        self.device = model.device
        self.B = batch_slots
        self.T = max_seq
        self._sample = _Sampler(temperature, seed, self.device)
        self.paged = paged
        self.page_size = page_size
        self.prefill_chunk = min(prefill_chunk, max_seq)
        step = lambda op, build: _cached(  # noqa: E731
            opcache, model, op, build, B=batch_slots, T=max_seq,
            paged=paged, page=page_size, chunk=self.prefill_chunk)
        if paged:
            _check_chunking(max_seq, page_size, self.prefill_chunk)
            self.cache = _resident(
                registry, cache_key, lambda dev: model.init_paged_cache(
                    batch_slots, max_seq, page_size, device=dev))
            self._pos_limit = self.cache["table"].shape[1] * page_size
            self._decode = step("serve_decode_paged",
                                lambda: model.decode_step_paged)
            self._prefill_chunk_fn = step("serve_prefill_chunk",
                                          lambda: model.prefill_chunk_paged)
        else:
            self.cache = _resident(
                registry, cache_key, lambda dev: model.init_cache(
                    batch_slots, max_seq, device=dev))
            self._pos_limit = max_seq
            self._decode = step("serve_decode", lambda: model.decode_step)
            self._prefill_one = step("serve_prefill",
                                     lambda: _make_prefill_fn(model))
        # the dense KV cache (a windowed config's rings, the hybrid's
        # sites) as one page per slot: the table is made once, seq_lens
        # (pos + 1) is one host-to-device copy per step
        self._table = (torch.arange(batch_slots, dtype=torch.int32,
                                    device=self.device)[:, None]
                       if not paged and model.cfg.family != "ssm"
                       else None)
        self.pos = np.zeros(batch_slots, np.int32)
        self.active: List[Optional[Request]] = [None] * batch_slots
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.refused: List[Request] = []     # deadline-shed queued work

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        if req.submit_t is None:
            req.submit_t = time.perf_counter()
        self.queue.append(req)

    def _prefill_chunks(self, row, prompt):
        """Run a prompt through the chunked paged prefill; returns the
        final chunk's logits (1, C, V) and the index of its last real
        position."""
        C = self.prefill_chunk
        P = len(prompt)
        logits = None
        for start in range(0, P, C):
            chunk = np.zeros((1, C), np.int64)
            n = min(C, P - start)
            chunk[0, :n] = prompt[start:start + n]
            logits, self.cache = self._prefill_chunk_fn(
                self.params, self.cache,
                torch.from_numpy(chunk).to(self.device), row, start)
        return logits, (P - 1) % C if P % C else C - 1 if P else 0

    def _shed_expired(self):
        """Deadline TTL for queued work (admitted slots always finish):
        expired requests leave with a structured DeadlineExceeded."""
        now = time.perf_counter()
        for req in [r for r in self.queue if r.expired(now)]:
            self.queue.remove(req)
            req.refusal = DeadlineExceeded(
                rid=req.rid, reason="deadline",
                deadline_s=float(req.deadline_s),
                waited_s=now - req.submit_t,
                n_preempted=req.n_preempted)
            req.done = True
            req.finish_t = now
            self.refused.append(req)
            self.obs.counter("serve.deadline_shed").inc()

    def _admit(self):
        self._shed_expired()
        for b in range(self.B):
            if self.active[b] is None and self.queue:
                req = self.queue.pop(0)
                req.admit_t = time.perf_counter()
                t0 = time.perf_counter() if self.obs.enabled else 0.0
                if self.paged:
                    # slot-major page ownership: slot b's table row is
                    # constant
                    row = self.cache["table"][b]
                    last, idx = self._prefill_chunks(row, req.prompt)
                    last_logits = last[:, idx, :]
                else:
                    toks = torch.from_numpy(
                        np.asarray(req.prompt, np.int64)[None]).to(
                            self.device)
                    last_logits, self.cache = self._prefill_one(
                        self.params, self.cache, toks, b)
                if self.obs.enabled:
                    _sync(self.obs, self.device)
                    self.obs.histogram("serve.prefill_s").observe(
                        time.perf_counter() - t0)
                    self.obs.counter("serve.prefills").inc()
                nxt = self._sample(last_logits)[0]
                req.out.append(int(nxt))
                req.first_token_t = time.perf_counter()
                self.active[b] = req
                self.pos[b] = len(req.prompt)

    def _release_slot(self, req: Request, b: int):
        pass                        # fixed rows: nothing to free

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One engine tick: admit, decode one token for every active slot."""
        self._admit()
        if not any(r is not None for r in self.active):
            return 0
        tokens = np.zeros((self.B, 1), np.int64)
        for b, r in enumerate(self.active):
            if r is not None:
                tokens[b, 0] = r.out[-1]
        # idle slots park at position 0; their garbage write is overwritten
        # by the next prefill before anything reads it
        _check_positions(self.pos, self._pos_limit)
        kw = {}
        if self._table is not None:
            kw = dict(block_table=self._table, seq_lens=torch.from_numpy(
                self.pos + np.int32(1)).to(self.device))
        t0 = time.perf_counter() if self.obs.enabled else 0.0
        logits, self.cache = self._decode(
            self.params, self.cache, torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(self.pos.astype(np.int64)).to(self.device), **kw)
        if self.obs.enabled:
            _sync(self.obs, self.device)
            self.obs.histogram("serve.decode_s").observe(
                time.perf_counter() - t0)
        nxt = self._sample(logits[:, 0, :])
        n_active = 0
        for b, r in enumerate(self.active):
            if r is None:
                continue
            r.out.append(int(nxt[b]))
            self.pos[b] += 1
            n_active += 1
            if len(r.out) >= r.max_new_tokens or self.pos[b] >= self.T - 1:
                _retire(self, b)
        self.obs.counter("serve.decode_tokens").inc(n_active)
        return n_active

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        ticks = 0
        while (self.queue or any(r is not None for r in self.active)) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        return list(self.finished)


class ContinuousEngine:
    """Continuous batching over a block-paged KV pool.

    Per tick: admit from the scheduler while slots AND pool headroom
    allow, run ONE prefill chunk for every mid-prefill sequence, grow
    page tables lazily for the decode-ready set (preempting the youngest
    sequence on pool exhaustion), then decode one token for every ready
    slot at its own position.  Finished sequences retire through the
    shared :func:`_retire` path and their pages recycle into the free
    list, so one run admits far more sequences than ``batch_slots``.
    Idle slots decode token 0 at position 0 against the NULL page.
    """

    def __init__(self, model, params, batch_slots: int, max_seq: int,
                 temperature: float = 0.0, seed: int = 0,
                 opcache=None, registry=None, cache_key: str = None,
                 obs=None, page_size: int = 64,
                 num_pages: Optional[int] = None, prefill_chunk: int = 32,
                 policy: str = "fifo"):
        self.obs = obs if obs is not None else obs_mod.NULL
        self.model = model
        self.params = params
        self.device = model.device
        self.B = batch_slots
        self.T = max_seq
        self._sample = _Sampler(temperature, seed, self.device)
        self.page_size = page_size
        self.prefill_chunk = min(prefill_chunk, max_seq)
        _check_chunking(max_seq, page_size, self.prefill_chunk)

        n_row = -(-max_seq // page_size)
        if num_pages is None:
            # full static capacity (+ the NULL page), clamped to the
            # registry's remaining budget
            num_pages = 1 + batch_slots * n_row
            if registry is not None and registry.capacity is not None:
                # on a mesh a rank holds 1/size of the pool's pages
                mesh = getattr(model, "mesh", None)
                shards = mesh.size if mesh is not None else 1
                headroom = registry.capacity - registry.total_bytes()
                num_pages = min(num_pages, pool_pages_for_budget(
                    headroom * shards, model.cfg, page_size))
        self.blocks = BlockManager(model.cfg, num_pages=num_pages,
                                   page_size=page_size, max_seq=max_seq)
        self.sched = Scheduler(self.blocks, policy=policy)
        self._pos_limit = n_row * page_size

        self._table_np = np.full((batch_slots, n_row), NULL_PAGE, np.int32)
        self._table_dirty = True

        def make(dev):
            pool = model.init_paged_pool(num_pages, page_size, device=dev)
            pool["table"] = torch.from_numpy(self._table_np.copy()).to(
                self.device if dev is None else dev)
            return pool

        # the pool and its table: one registry entry
        self.cache: Dict[str, torch.Tensor] = _resident(registry, cache_key,
                                                        make)
        # the same ops (and keys) as the static paged engine
        step = lambda op, build: _cached(  # noqa: E731
            opcache, model, op, build, B=batch_slots, T=max_seq, paged=True,
            page=page_size, chunk=self.prefill_chunk)
        self._decode = step("serve_decode_paged",
                            lambda: model.decode_step_paged)
        self._prefill_chunk_fn = step("serve_prefill_chunk",
                                      lambda: model.prefill_chunk_paged)
        self.pos = np.zeros(batch_slots, np.int32)
        self.active: List[Optional[Request]] = [None] * batch_slots
        self.finished: List[Request] = []
        # fault/chaos seams: called as hook(tick) at the top of every
        # step() — repro_torch.faults.arm_engine registers pool storms here
        self.tick_hooks: List[Callable[[int], None]] = []
        self._tick = 0

    # ------------------------------------------------------------------
    @property
    def queue(self) -> List[Request]:
        return list(self.sched.queue)

    @property
    def refused(self) -> List[Request]:
        return list(self.sched.refused)

    @property
    def shed(self) -> List[Request]:
        """Queued requests shed on deadline (structured DeadlineExceeded)."""
        return list(self.sched.shed)

    def submit(self, req: Request):
        refusal = self.sched.submit(req)
        if refusal is not None and self.obs.enabled:
            self.obs.counter("serve.refusals").inc()

    def _release_slot(self, req: Request, b: int):
        self.blocks.free(req.rid)
        self._table_np[b] = NULL_PAGE
        self._table_dirty = True

    # ------------------------------------------------------------------
    def _admit(self):
        for req in self.sched.shed_expired():
            self.obs.counter("serve.deadline_shed").inc()
        for b in range(self.B):
            if self.active[b] is not None:
                continue
            req = self.sched.next_admission()
            if req is None:
                break
            # admission reserved prompt+max_new headroom; only the prompt
            # pages are taken now — decode growth allocates lazily
            self.blocks.alloc(req.rid, len(req.prompt))
            req.admit_t = time.perf_counter()
            if self.obs.enabled:
                self.obs.histogram("serve.queue_wait_s").observe(
                    req.admit_t - req.submit_t)
            req.prefill_pos = 0
            self.active[b] = req
            self.pos[b] = 0

    def _prefill_tick(self):
        """ONE chunk for every mid-prefill sequence (interleaved with
        decode ticks, so long prompts never starve running decodes)."""
        C = self.prefill_chunk
        for b, req in enumerate(self.active):
            if req is None or req.prefill_pos >= len(req.prompt):
                continue
            P = len(req.prompt)
            start = req.prefill_pos
            n = min(C, P - start)
            chunk = np.zeros((1, C), np.int64)
            chunk[0, :n] = req.prompt[start:start + n]
            row = torch.from_numpy(self.blocks.table_row(req.rid)).to(
                self.device)
            t0 = time.perf_counter() if self.obs.enabled else 0.0
            logits, self.cache = self._prefill_chunk_fn(
                self.params, self.cache,
                torch.from_numpy(chunk).to(self.device), row, start)
            if self.obs.enabled:
                _sync(self.obs, self.device)
                self.obs.histogram("serve.prefill_s").observe(
                    time.perf_counter() - t0)
            req.prefill_pos = start + n
            if req.prefill_pos >= P:      # final chunk: first token
                nxt = self._sample(logits[:, n - 1, :])[0]
                req.out.append(int(nxt))
                req.first_token_t = time.perf_counter()
                if self.obs.enabled:
                    self.obs.histogram("serve.ttft_s").observe(
                        req.first_token_t - req.submit_t)
                    self.obs.counter("serve.prefills").inc()
                self.pos[b] = P
                self._table_np[b] = self.blocks.table_row(req.rid)
                self._table_dirty = True

    def _preempt(self, victim: Request):
        """Free the victim's pages and requeue it at the FRONT (full
        restart: greedy decode regenerates the same tokens)."""
        vb = next(b for b, r in enumerate(self.active) if r is victim)
        self.blocks.free(victim.rid)
        self._table_np[vb] = NULL_PAGE
        self._table_dirty = True
        self.active[vb] = None
        self.pos[vb] = 0
        refusal = self.sched.requeue_preempted(victim)
        self.obs.counter("serve.preemptions").inc()
        if refusal is not None:
            self.obs.counter("serve.preempt_refused").inc()

    def _extend_or_preempt(self, ready: List[int]) -> List[int]:
        """Grow tables so every ready slot can write ``pos[b]``; on pool
        exhaustion preempt the youngest admitted sequence and retry."""
        for b in list(ready):
            req = self.active[b]
            if req is None:                   # preempted by an earlier
                continue                      # slot's extend this tick
            while True:
                if req is not self.active[b]:
                    break                     # b itself was preempted
                try:
                    before = self.blocks.owned(req.rid)
                    self.blocks.extend(req.rid, int(self.pos[b]) + 1)
                    if self.blocks.owned(req.rid) != before:
                        self._table_np[b] = self.blocks.table_row(req.rid)
                        self._table_dirty = True
                    break
                except PoolExhausted:
                    victim = self.sched.victim(self.active)
                    self._preempt(victim)
        return [b for b in ready if self.active[b] is not None]

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One engine tick: admit, prefill one chunk each, extend/preempt,
        decode one token for every ready slot, retire finished."""
        for hook in self.tick_hooks:
            hook(self._tick)
        self._tick += 1
        self._admit()
        self._prefill_tick()
        ready = [b for b, r in enumerate(self.active)
                 if r is not None and r.prefill_pos >= len(r.prompt)]
        ready = self._extend_or_preempt(ready)
        n_ready = len(ready)
        if n_ready:
            if self._table_dirty:
                self.cache["table"] = torch.from_numpy(
                    self._table_np.copy()).to(self.device)
                self._table_dirty = False
            tokens = np.zeros((self.B, 1), np.int64)
            pos = np.zeros(self.B, np.int64)
            for b in ready:
                tokens[b, 0] = self.active[b].out[-1]
                pos[b] = self.pos[b]
            _check_positions(pos, self._pos_limit)
            t0 = time.perf_counter() if self.obs.enabled else 0.0
            logits, self.cache = self._decode(
                self.params, self.cache,
                torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(pos).to(self.device))
            if self.obs.enabled:
                _sync(self.obs, self.device)
                self.obs.histogram("serve.decode_s").observe(
                    time.perf_counter() - t0)
            nxt = self._sample(logits[:, 0, :])
            for b in ready:
                r = self.active[b]
                r.out.append(int(nxt[b]))
                self.pos[b] += 1
                if len(r.out) >= r.max_new_tokens \
                        or self.pos[b] >= self.T - 1:
                    _retire(self, b)
            self.obs.counter("serve.decode_tokens").inc(n_ready)
        if self.obs.enabled:
            self.obs.gauge("serve.pool_blocks_used").set(
                self.blocks.used_pages)
        return n_ready

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        ticks = 0
        while (self.sched.queue
               or any(r is not None for r in self.active)) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        return list(self.finished)
