"""Sample harvesting of the port: the sample format of
``repro.calibrate.harvest`` (copied, so that the port never imports the
JAX package) and kernel microbenchmarks timed on the port's dispatch.

A calibration *sample* is one measured execution: how much work it did
(FLOPs, HBM bytes, interconnect bytes) and how long it took (wall
seconds), tagged with an op class.  :func:`microbench_kernels` times the
port's ops (``flash_attention``, ``block_sparse_matmul``,
``intrablock_gather_matmul``) and a dense ``torch.matmul`` on the card,
with analytically counted FLOPs and bytes for the exact shapes run.  The
samples' JSONL is the reference's, so ``python -m repro.calibrate fit
--ledger`` reads it as it reads the reference's.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .. import resolve_device

if TYPE_CHECKING:
    import torch

__all__ = ["Sample", "HarvestReport", "record_to_sample", "from_ledger",
           "read_samples", "write_samples", "microbench_kernels"]

_TIME_KEYS = ("time_s", "wall_s", "step_time_s")


@dataclasses.dataclass(frozen=True)
class Sample:
    """One measured execution, per device."""

    op_class: str
    flops: float
    bytes: float
    coll_bytes: float
    time_s: float
    meta: Tuple[Tuple[str, object], ...] = ()

    def to_record(self) -> Dict[str, object]:
        return {"op_class": self.op_class, "flops": self.flops,
                "bytes": self.bytes, "coll_bytes": self.coll_bytes,
                "time_s": self.time_s, "meta": dict(self.meta)}


@dataclasses.dataclass
class HarvestReport:
    """What a harvest pass produced — and what it had to leave behind."""

    samples: List[Sample]
    skipped_untimed: int = 0     # well-formed records with no time field
    skipped_malformed: int = 0   # undecodable / key-incomplete records

    def merged(self, other: "HarvestReport") -> "HarvestReport":
        return HarvestReport(
            samples=self.samples + other.samples,
            skipped_untimed=self.skipped_untimed + other.skipped_untimed,
            skipped_malformed=self.skipped_malformed + other.skipped_malformed)


def _coll_total(rec: Dict) -> float:
    coll = rec.get("collective_bytes", 0.0)
    if isinstance(coll, dict):
        return float(sum(v for k, v in coll.items() if k != "count"))
    return float(coll or 0.0)


def record_to_sample(rec: Dict) -> Optional[Sample]:
    """Normalise one JSONL record (sample-format or dry-run-ledger
    format) into a :class:`Sample`; ``None`` if it carries no timing."""
    if not isinstance(rec, dict) or "error" in rec:
        return None
    t = next((rec[k] for k in _TIME_KEYS if isinstance(rec.get(k), (int, float))
              and rec[k] > 0), None)
    if t is None:
        return None
    if "op_class" in rec:                      # native sample format
        flops, nbytes = rec.get("flops", 0.0), rec.get("bytes", 0.0)
        coll = float(rec.get("coll_bytes", 0.0) or 0.0)
        op_class = str(rec["op_class"])
        meta = rec.get("meta", {})
    elif "bytes_accessed" in rec:              # dry-run ledger format
        flops, nbytes = rec.get("flops", 0.0), rec["bytes_accessed"]
        coll = _coll_total(rec)
        op_class = f"step:{rec.get('kind', 'train')}"
        meta = {k: rec[k] for k in ("arch", "cell", "mesh", "tag", "chips")
                if k in rec}
    else:
        return None
    try:
        return Sample(op_class=op_class, flops=float(flops),
                      bytes=float(nbytes), coll_bytes=coll,
                      time_s=float(t),
                      meta=tuple(sorted((str(k), v) for k, v in meta.items())))
    except (TypeError, ValueError):
        return None


def _iter_records(path: Union[str, Path]):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield line


def from_ledger(path: Union[str, Path]) -> HarvestReport:
    """Harvest every timed record of a JSONL ledger (either format)."""
    rep = HarvestReport(samples=[])
    for line in _iter_records(path):
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            rep.skipped_malformed += 1
            continue
        s = record_to_sample(rec)
        if s is None:
            if isinstance(rec, dict) and not any(k in rec for k in _TIME_KEYS):
                rep.skipped_untimed += 1
            else:
                rep.skipped_malformed += 1
        else:
            rep.samples.append(s)
    return rep


def read_samples(path: Union[str, Path]) -> List[Sample]:
    return from_ledger(path).samples


def write_samples(samples: Sequence[Sample], path: Union[str, Path],
                  *, append: bool = True) -> Path:
    path = Path(path)
    if path.parent and str(path.parent) not in (".", ""):
        path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a" if append else "w") as f:
        for s in samples:
            f.write(json.dumps(s.to_record()) + "\n")
    return path


# ---------------------------------------------------------------------------
# Kernel microbenchmarks
# ---------------------------------------------------------------------------

def _time_call(fn, *args, repeats: int, device: torch.device, **kw) -> float:
    """Best-of-``repeats`` wall seconds, after one warm-up call, each call
    ended by a device synchronisation on a card."""
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn(*args, **kw)
    sync()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args, **kw)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def _device_name(device: torch.device) -> str:
    import torch

    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return f"{device.type}:{device.type}"


def microbench_kernels(*, sizes: Sequence[int] = (256, 512), repeats: int = 3,
                       impl: str = "auto", seed: int = 0,
                       device: Optional[Union[str, torch.device]] = None) -> HarvestReport:
    """Time the port's kernel dispatch at each size ``S``, on ``device``
    (default ``cuda``), with the ops ``impl`` selects:

    * ``attention``  — causal flash attention over (1, S, 4, 64);
    * ``matmul``     — FullBlock block-sparse matmul, (128, S) @ (S, S) at
      50% block sparsity, plus a dense ``torch.matmul`` of the same shape;
    * ``intrablock`` — row-aligned IntraBlock(4, 2) gather-matmul.

    Inputs are f32 and drawn from ``numpy.random.default_rng(seed)`` in
    the reference's order, so the op classes, analytic FLOPs/bytes and
    ``shape`` meta equal those of ``repro.calibrate.harvest``.  Unlike
    the reference, a failing kernel is not skipped: its error propagates.
    """
    import torch

    from ..kernels import ops

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    device_name = _device_name(dev)
    samples: List[Sample] = []

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def add(op_class, fn, *args, flops, nbytes, shape, **kw):
        t = _time_call(fn, *args, repeats=repeats, device=dev, **kw)
        samples.append(Sample(
            op_class=op_class, flops=float(flops), bytes=float(nbytes),
            coll_bytes=0.0, time_s=t,
            meta=(("device", device_name), ("impl", ops._resolve(impl, args[0])),
                  ("repeats", repeats), ("shape", str(shape)))))

    for S in sizes:
        B, H, hd = 1, 4, 64
        q = tensor(rng.standard_normal((B, S, H, hd)))
        k = tensor(rng.standard_normal((B, S, H, hd)))
        v = tensor(rng.standard_normal((B, S, H, hd)))
        # causal scores + weighted sum: 2 matmuls over the lower triangle
        att_flops = 2 * 2 * B * H * (S * S / 2) * hd
        att_bytes = 4 * (3 + 1) * B * S * H * hd
        add("attention", ops.flash_attention, q, k, v,
            causal=True, impl=impl, flops=att_flops, nbytes=att_bytes,
            shape=(B, S, H, hd))

        w = rng.standard_normal((S, S)).astype(np.float32)
        x = tensor(rng.standard_normal((128, S)))
        bm = bn = max(32, S // 8)
        keep = rng.random((S // bm, S // bn)) < 0.5
        keep[0, :] = True                       # every column keeps >= 1 block
        w_comp, idx = ops.compress_fullblock(w, keep, bm, bn)
        kept = int(keep.sum())
        add("matmul", ops.block_sparse_matmul,
            x, tensor(w_comp), torch.as_tensor(idx, device=dev), impl=impl,
            flops=2 * 128 * bm * bn * kept,
            nbytes=4 * (128 * S + kept * bm * bn + 128 * S),
            shape=(128, S, f"{kept}blk"))
        add("matmul", torch.matmul, x, tensor(w),
            flops=2 * 128 * S * S, nbytes=4 * (128 * S + S * S + 128 * S),
            shape=(128, S, "dense"))

        m, phi = 4, 2
        pat = np.zeros((S // m, m), bool)
        for i in range(S // m):
            pat[i, rng.choice(m, size=phi, replace=False)] = True
        mask = np.repeat(pat[:, :, None], S, axis=2).reshape(S, S)
        wc, row_idx = ops.compress_intrablock(w, mask, m)
        add("intrablock", ops.intrablock_gather_matmul,
            x, tensor(wc), torch.as_tensor(row_idx, device=dev), impl=impl,
            flops=2 * 128 * wc.shape[0] * S,
            nbytes=4 * (128 * S + wc.size + 128 * S),
            shape=(128, S, f"{m}:{phi}"))

    return HarvestReport(samples=samples)
