"""What decides ``correct``: the served tokens held to the plain reference.

Once the window has closed, a sample of the requests the window
finished is drawn from the seed, the longest of them (prompt and output)
always in it, until it holds ``check.tokens`` served tokens or
``check.max_requests`` requests.  The reference runs once over each
prompt with its served tokens (teacher-forced) and gives, at the
position of each served token, its own best logit; a token's gap is by
how much the served token's logit lies below that best (0 where the
served token is the reference's choice).  The widest gap over the sample
is held to the configuration's limit.  Beside it, every request the
window finished must carry exactly the number of tokens it asked for
(``eos_id`` is -1), with every id inside the vocabulary.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["sample", "gaps", "judge"]


def sample(records, w0: float, w1: float, seed: int, tokens: int, max_requests: int) -> List:
    done = [r for r in records if r.end is not None and w0 < r.end <= w1 and not r.rejected]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.prompt) + len(r.output), -r.index))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed) % 2**64, 0x636b])
    picked, n = [longest], len(longest.output)
    for i in rng.permutation(len(rest)):
        if n >= tokens or len(picked) >= max_requests:
            break
        picked.append(rest[int(i)])
        n += len(rest[int(i)].output)
    return picked


def gaps(ref_logits: List[torch.Tensor], served: List[List[int]]) -> np.ndarray:
    """Per served token, the reference's best logit minus its logit of the
    served token."""
    out = []
    for lg, toks in zip(ref_logits, served):
        t = torch.as_tensor(toks, device=lg.device, dtype=torch.long)
        out.append((lg.max(dim=-1).values - lg.gather(1, t[:, None])[:, 0]).double().cpu())
    return torch.cat(out).numpy() if out else np.zeros(0)


def control_gaps(ref_logits: List[torch.Tensor], ctl_logits: List[torch.Tensor]) -> np.ndarray:
    """The gap of the token the control puts first, at each position."""
    return gaps(ref_logits, [lg.argmax(dim=-1).tolist() for lg in ctl_logits])


def judge(cfg: dict, seed: int, records, w0: float, w1: float, mix, device,
          limits: Dict[str, float], keep: Optional[dict] = None) -> Dict[str, dict]:
    """The numbers compared, each with its limit, and ``correct``.
    ``limits`` maps ``max_logit_gap`` and/or ``mean_logit_gap`` to its
    limit; ``keep``, when given, receives the sample and the reference's
    logits."""
    vocab = cfg["arch"]["vocab_size"]
    done = [r for r in records if r.end is not None and w0 < r.end <= w1 and not r.rejected]
    short = sum(1 for r in done if len(r.output) != r.new_tokens)
    out_of_vocab = sum(1 for r in done for t in r.output if not 0 <= t < vocab)
    picked = sample(records, w0, w1, seed, mix.check_tokens, mix.check_requests)
    ref = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    logits = ref.served_logits(cfg, seed, [(r.prompt, r.output) for r in picked], device)
    g = gaps(logits, [r.output for r in picked])
    if keep is not None:
        keep.update(picked=picked, logits=logits)
    del logits
    gap = {"max_logit_gap": float(g.max()) if g.size else None,
           "mean_logit_gap": float(g.mean()) if g.size else None}
    numbers = {name: {"value": gap[name], "holds": "<=", "limit": lim}
               for name, lim in limits.items()}
    numbers.update({
        "requests_wrong_length": {"value": short, "holds": "<=", "limit": 0},
        "tokens_outside_vocab": {"value": out_of_vocab, "holds": "<=", "limit": 0},
        "tokens_compared": {"value": int(g.size), "holds": ">=", "limit": 1},
    })
    ok = (g.size >= 1 and short == 0 and out_of_vocab == 0
          and all(gap[name] <= lim for name, lim in limits.items()))
    return {"correct": ok, "numbers": numbers, "requests": len(picked),
            "max_gap": gap["max_logit_gap"], "mean_gap": gap["mean_logit_gap"],
            "flipped": int((g > 0).sum())}
