"""Training loop with fault tolerance (port of ``repro/train/trainer.py``).

* checkpoint/restart — atomic saves every ``ckpt_every`` steps and at the
  end, data-pipeline state included; on start, auto-resume from the
  latest complete checkpoint.
* failure handling — a step that raises (device OOM, an injected fault in
  tests) triggers restore-from-last-checkpoint and replay; after
  ``max_retries`` consecutive failures the trainer aborts, the root cause
  chained and named.
* straggler log — a step over ``straggler_factor ×`` the EMA of step
  times (after step 5) is recorded.
* NaN/inf guard — a non-finite loss leaves params and optimizer state as
  they were and is counted.

The step updates params and optimizer state in place
(:mod:`~repro_torch.train.step`), and writes nothing for a non-finite
loss.  A step that raises in its forward, backward or compression leaves
them as they were; one that raises during the in-place update itself
(after the loss check) can leave them part-written, and only a restore
from a checkpoint repairs that (the reference's pure step cannot).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ArchConfig
from ..data.pipeline import TokenPipeline
from ..models.transformer import init_params
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .optimizer import AdamWConfig, adamw_init
from .step import make_train_step

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    log_every: int = 10
    max_retries: int = 3
    straggler_factor: float = 3.0
    microbatches: int = 1
    seed: int = 0
    param_dtype: torch.dtype = torch.float32
    device: Optional[Union[str, torch.device]] = None      # None: the card


class Trainer:
    """Trains ``cfg`` from ``init_params(cfg, tcfg.seed)`` on batches of
    ``pipeline``.  ``masks`` (``prune_params``'s) make it sparse
    fine-tuning; ``remat``/``remat_policy`` go to the forward;
    ``extra_batch_fn(batch)`` adds inputs (a stub ``enc_embed`` or
    ``prefix_embed``) to each batch of tensors."""

    def __init__(self, cfg: ArchConfig, opt_cfg: AdamWConfig, tcfg: TrainerConfig,
                 pipeline: TokenPipeline, *, masks=None,
                 extra_batch_fn: Optional[Callable] = None, remat: bool = False,
                 remat_policy: str = "minimal"):
        self.cfg, self.opt_cfg, self.tcfg = cfg, opt_cfg, tcfg
        self.device = resolve_device(tcfg.device)
        self.pipeline = pipeline
        self.extra_batch_fn = extra_batch_fn
        self.step_fn = make_train_step(cfg, opt_cfg, microbatches=tcfg.microbatches,
                                       masks=masks, remat=remat, remat_policy=remat_policy)
        self.metrics_log: List[Dict] = []
        self.straggler_events: List[int] = []
        self.skipped_nonfinite: int = 0
        self._init_state()

    # -- state ------------------------------------------------------------------
    def _init_state(self):
        self.params = init_params(self.cfg, self.tcfg.seed, dtype=self.tcfg.param_dtype,
                                  device=self.device)
        self.opt_state = adamw_init(self.params)
        self.start_step = 0
        if self.tcfg.ckpt_dir and latest_step(self.tcfg.ckpt_dir) is not None:
            self._restore()

    def _restore(self):
        self.params, self.opt_state, meta = restore_checkpoint(
            self.tcfg.ckpt_dir, self.params, self.opt_state)
        self.start_step = int(meta["step"])
        ds = meta.get("data_state") or {}
        if ds:
            self.pipeline = TokenPipeline.from_state(self.pipeline.cfg, ds)

    def _save(self, step: int):
        if not self.tcfg.ckpt_dir:
            return
        save_checkpoint(self.tcfg.ckpt_dir, step, self.params, self.opt_state,
                        data_state=self.pipeline.state(), keep=self.tcfg.keep_ckpts)

    # -- loop ---------------------------------------------------------------------
    def _one_step(self, batch) -> Dict[str, float]:
        tb: Dict[str, Any] = {k: torch.as_tensor(v, device=self.device)
                              for k, v in batch.items()}
        if self.extra_batch_fn is not None:
            tb.update(self.extra_batch_fn(tb))
        _, _, metrics = self.step_fn(self.params, self.opt_state, tb)
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            self.skipped_nonfinite += 1
            return {"loss": loss, "skipped": 1.0}
        return {k: float(v) for k, v in metrics.items()}

    def train(self, fault_hook: Optional[Callable[[int], None]] = None) -> List[Dict]:
        """Run to ``tcfg.steps``.  ``fault_hook(step)`` (tests) may raise to
        simulate a node failure at a given step."""
        step = self.start_step
        retries = 0
        ema = None
        while step < self.tcfg.steps:
            batch = self.pipeline.next_batch()
            t0 = time.monotonic()
            try:
                if fault_hook is not None:
                    fault_hook(step)
                metrics = self._one_step(batch)
                retries = 0
            except Exception as e:  # noqa: BLE001 — deliberate catch-all
                retries += 1
                if retries > self.tcfg.max_retries:
                    raise RuntimeError(
                        f"step {step} failed {retries} times; aborting "
                        f"(root cause: {type(e).__name__}: {e})") from e
                # failure recovery: restore the last complete checkpoint
                if self.tcfg.ckpt_dir and latest_step(self.tcfg.ckpt_dir) is not None:
                    self._restore()
                    step = self.start_step
                continue
            dt = time.monotonic() - t0
            ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            if dt > self.tcfg.straggler_factor * ema and step > 5:
                self.straggler_events.append(step)
            metrics.update(step=step, wall_s=dt)
            self.metrics_log.append(metrics)
            step += 1
            if step % self.tcfg.ckpt_every == 0 or step == self.tcfg.steps:
                self._save(step)
        return self.metrics_log
