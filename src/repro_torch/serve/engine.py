"""Batched greedy serving engine over a fixed slot pool (port of
``repro/serve/engine.py``).

Requests occupy slots.  A free slot is filled by a batch-1 prefill of
the next queued request, whose KV is merged into the slot's lanes of the
pool cache; every engine step then decodes one token for all slots, each
at its own (B,) cache position.  Finished slots (EOS, max tokens, cache
full) free and refill from the queue.  ``max_queue`` bounds admission
(rejects with ``reject_reason="queue_full"``) and ``Request.deadline_s``
drops a queued request or cuts off a decoding one.

As in the reference, construction runs the warn-only model-plane
pre-flight on the config's ``lm_workload`` (:func:`repro_torch.analysis.preflight`),
and each step records an ``obs.counter("serve.step", ...)`` when an
observer is enabled.  Neither changes an output.

With an observer enabled the engine also records its own trace
(:mod:`repro_torch.models.spans`): an ``engine.submit`` event (``rid``,
``prompt_len``) and an ``engine.done`` event (``rid``, ``tokens``,
``reason``) per request, and per step an ``engine.step`` span holding
``engine.fill`` (the queue scan and the prefills, each an
``engine.prefill`` span with ``rid``, ``slot`` and ``prompt_len``),
``engine.decode`` (the ``decode_step`` call, with ``active`` slots, the
``filled`` cache positions Σ ``slot_pos`` over them and the ``attended``
positions ``slots × max_len``), ``engine.read`` (the host's wait for the
next tokens) and ``engine.bookkeeping``.  Every attribute is host state
the engine holds; no span reads a value back from the device.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .. import obs, resolve_device
from ..analysis import preflight
from ..configs.base import ArchConfig
from ..core.workload import lm_workload
from ..models.spans import span
from ..models.transformer import decode_step, init_cache, prefill
from ..obs.metrics import ServeMetrics

__all__ = ["Request", "ServeEngine"]


@dataclasses.dataclass
class Request:
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 16
    eos_id: int = -1                # -1 = never
    # wall-second budget from submit(); None = no deadline
    deadline_s: Optional[float] = None
    # filled by the engine:
    output: Optional[List[int]] = None
    done: bool = False
    reject_reason: Optional[str] = None   # "queue_full" | "deadline"
    submit_t: Optional[float] = None      # monotonic submit time, for TTFT
    rid: Optional[int] = None             # the request's id in the engine's trace


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, *, slots: int = 4, max_len: int = 256,
                 greedy: bool = True, max_queue: Optional[int] = None,
                 dtype=torch.float32, impl: str = "auto",
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg, self.params = cfg, params
        self.slots, self.max_len = slots, max_len
        self.max_queue = max_queue
        # warn-only pre-flight: a structurally broken config surfaces here,
        # not as a shape error mid-request
        preflight(lm_workload(cfg, seq_len=max_len, batch=slots),
                  strict=False, where="serve.engine")
        # kept as the reference keeps it; decoding is argmax either way
        self.greedy = greedy
        self.impl = impl
        self.device = resolve_device(device)
        self.cache = init_cache(cfg, slots, max_len, dtype=dtype, device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.slot_remaining = np.zeros(slots, np.int64)
        self.slot_pos = np.zeros(slots, np.int64)     # per-slot lengths
        self.queue: List[Request] = []
        self._last_tokens = np.zeros(slots, np.int32)
        self.metrics = ServeMetrics()
        self.last_stats: Dict[str, Any] = {}
        self._rids = itertools.count()

    # -- request management --------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Admit ``req`` (True) or reject it with backpressure (False)."""
        req.rid = next(self._rids)
        obs.event("engine.submit", rid=req.rid, prompt_len=len(req.prompt))
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            req.reject_reason = "queue_full"
            self.metrics.on_reject()
            obs.event("engine.done", rid=req.rid, tokens=0, reason="queue_full")
            return False
        req.output = []
        req.submit_t = time.monotonic()
        self.queue.append(req)
        self.metrics.on_submit()
        return True

    def _expired(self, req: Request, now: float) -> bool:
        return (req.deadline_s is not None and req.submit_t is not None
                and now - req.submit_t > req.deadline_s)

    def _fill_slots(self) -> None:
        now = time.monotonic()
        kept: List[Request] = []
        for req in self.queue:
            if self._expired(req, now):
                req.reject_reason = "deadline"
                self.metrics.on_expire(queued=True)
                obs.event("engine.done", rid=req.rid, tokens=0, reason="deadline")
            else:
                kept.append(req)
        self.queue = kept
        for s in range(self.slots):
            if self.slot_req[s] is None and self.queue:
                self._prefill_slot(s, self.queue.pop(0))

    def _prefill_slot(self, s: int, req: Request) -> None:
        """Batch-1 prefill of the prompt, merged into slot ``s`` of the pool
        (k/v, SSM and conv states, each where the cache has it)."""
        with span("engine.prefill", rid=req.rid, slot=s, prompt_len=len(req.prompt)):
            prompt = torch.as_tensor(np.asarray(req.prompt, np.int64), device=self.device)[None]
            S = prompt.shape[1]
            if S >= self.max_len:
                raise ValueError(f"prompt {S} ≥ max_len {self.max_len}")
            logits, pc = prefill(self.params, prompt, self.cfg, impl=self.impl)
            for key in ("k", "v"):
                if key in self.cache:
                    self.cache[key][:, s, :S] = pc[key][:, 0].to(self.cache[key].dtype)
            # the slot's SSM and conv states replace whatever its last request left
            for key in ("ssm", "conv"):
                if key in self.cache:
                    self.cache[key][:, s] = pc[key][:, 0].to(self.cache[key].dtype)
            tok = int(torch.argmax(logits[0, -1]))
        req.output.append(tok)
        self._last_tokens[s] = tok
        self.slot_req[s] = req
        self.slot_remaining[s] = req.max_new_tokens - 1
        self.slot_pos[s] = S
        self.metrics.on_scheduled()
        self.metrics.tokens_generated += 1       # the prefill's first token
        if req.submit_t is not None:
            self.metrics.on_first_token(time.monotonic() - req.submit_t)

    # -- decoding ------------------------------------------------------------
    def step(self) -> int:
        """Decode one token for all active slots; returns #active."""
        t0 = time.monotonic()
        with span("engine.step"):
            with span("engine.fill"):
                self._fill_slots()
            active = [s for s in range(self.slots) if self.slot_req[s] is not None]
            if not active:
                return 0
            self.cache["pos"] = torch.as_tensor(self.slot_pos, dtype=torch.int64,
                                                device=self.device)
            tokens = torch.as_tensor(self._last_tokens, dtype=torch.int64, device=self.device)
            with span("engine.decode", active=len(active),
                      filled=int(self.slot_pos[active].sum()),
                      attended=self.slots * self.max_len):
                logits, self.cache = decode_step(self.params, tokens, self.cfg, self.cache,
                                                 impl=self.impl)
            with span("engine.read"):
                next_tokens = torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)
            with span("engine.bookkeeping"):
                self._bookkeeping(active, next_tokens, t0)
        return len(active)

    def _bookkeeping(self, active: List[int], next_tokens: np.ndarray, t0: float) -> None:
        """Hand each active slot its next token, free the slots whose
        request ended, and record the step."""
        completed = 0
        now = time.monotonic()
        for s in active:
            req = self.slot_req[s]
            tok = int(next_tokens[s])
            req.output.append(tok)
            self._last_tokens[s] = tok
            self.slot_pos[s] += 1
            self.slot_remaining[s] -= 1
            if (self.slot_remaining[s] <= 0 or tok == req.eos_id
                    or self.slot_pos[s] >= self.max_len - 1):
                req.done = True
                self.slot_req[s] = None
                completed += 1
                reason = ("max_tokens" if self.slot_remaining[s] <= 0
                          else "eos" if tok == req.eos_id else "max_len")
                obs.event("engine.done", rid=req.rid, tokens=len(req.output), reason=reason)
            elif self._expired(req, now):
                req.reject_reason = "deadline"
                self.slot_req[s] = None
                self.metrics.on_expire(queued=False)
                obs.event("engine.done", rid=req.rid, tokens=len(req.output),
                          reason="deadline")
        step_s = time.monotonic() - t0
        m = self.metrics
        m.on_step(len(active), step_s)
        m.on_tokens(len(active), step_s)
        for _ in range(completed):
            m.on_complete()
        obs.counter("serve.step", len(active),
                    queue_depth=m.queue_depth, completed=completed)

    def run(self) -> None:
        """Drain queue + slots; leaves this call's deltas in ``last_stats``."""
        m = self.metrics
        before = (m.steps, m.tokens_generated, m.requests_completed, m.busy_s)
        t0 = time.monotonic()
        while self.queue or any(r is not None for r in self.slot_req):
            self.step()
        self.last_stats = {
            "steps": m.steps - before[0],
            "tokens_generated": m.tokens_generated - before[1],
            "requests_completed": m.requests_completed - before[2],
            "busy_s": m.busy_s - before[3],
            "wall_s": time.monotonic() - t0,
        }

    # -- exposition ----------------------------------------------------------
    def stats_snapshot(self) -> Dict[str, Any]:
        return self.metrics.snapshot()

    def stats_text(self) -> str:
        return self.metrics.render_text()
