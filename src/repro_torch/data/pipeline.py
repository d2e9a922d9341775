"""Deterministic synthetic token pipeline (a copy of
``repro/data/pipeline.py``; numpy only, so the same config and step give
the same batches, bit for bit, in both packages).

Seeded, stateful, restartable: the stream position is part of the
checkpointed training state, so restart-after-failure resumes on the
exact batch.  Sharded by host: each host draws only its slice of the
global batch (``host_id``/``n_hosts``), matching multi-host data
loading on a real pod.

Generates structured (not uniform) token streams — a mixture of Zipfian
unigrams and short repeated motifs — so language-model training loss has
actual signal to descend on in the end-to-end examples.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

__all__ = ["PipelineConfig", "TokenPipeline"]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    zipf_a: float = 1.2
    motif_len: int = 8
    motif_prob: float = 0.5


class TokenPipeline:
    """Iterator of training batches with explicit, checkpointable state."""

    def __init__(self, cfg: PipelineConfig, start_step: int = 0):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.cfg = cfg
        self._step = start_step
        # Zipfian unigram table (clipped to vocab)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._probs = probs / probs.sum()

    # -- checkpointable state -------------------------------------------------
    def state(self) -> Dict:
        return {"step": self._step, "seed": self.cfg.seed,
                "host_id": self.cfg.host_id}

    @classmethod
    def from_state(cls, cfg: PipelineConfig, state: Dict) -> "TokenPipeline":
        if state.get("seed", cfg.seed) != cfg.seed:
            raise ValueError("checkpoint seed mismatch")
        return cls(cfg, start_step=int(state["step"]))

    # -- batch generation --------------------------------------------------------
    def _rng_for(self, step: int) -> np.random.Generator:
        # independent stream per (seed, step, host): restart-stable
        return np.random.default_rng(
            np.random.SeedSequence(
                [self.cfg.seed, step, self.cfg.host_id]))

    def next_batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._rng_for(self._step)
        local_b = cfg.global_batch // cfg.n_hosts
        L = cfg.seq_len + 1
        toks = rng.choice(cfg.vocab_size, size=(local_b, L), p=self._probs)
        # inject repeated motifs (learnable structure)
        n_motifs = int(L * cfg.motif_prob / cfg.motif_len)
        motif_vocab = min(1000, cfg.vocab_size)
        for b in range(local_b):
            motif = rng.choice(motif_vocab, size=cfg.motif_len)
            for _ in range(n_motifs):
                pos = rng.integers(0, L - cfg.motif_len)
                toks[b, pos:pos + cfg.motif_len] = motif
        self._step += 1
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
