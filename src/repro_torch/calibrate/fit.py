"""Fit roofline parameters to harvested samples.

Copy of ``repro.calibrate.fit``: the port never imports the JAX package.

The model is the additive roofline in *inverse-peak* space: for sample
``i`` with per-device work ``(f_i FLOPs, b_i bytes, c_i collective
bytes)`` and measured wall time ``t_i``,

    t_i  ≈  f_i·θ_F + b_i·θ_B + c_i·θ_I ,   θ = (1/peak_flops,
                                                 1/hbm_bw, 1/ici_bw)

which is linear in θ, so calibration is a *bounded* least-squares
problem (peaks are physical: θ must stay inside
``1/upper ≤ θ ≤ 1/lower``).  Rows are scaled by ``1/t_i`` so every
sample counts by relative error, not absolute seconds — a 40 µs kernel
and a 400 ms training step pull equally.

After the global fit, each op class gets an *efficiency factor*: the
median ratio of roofline-predicted to measured time over that class's
samples.  Classes that sit on the fitted roofline get 1.0; a class
running at half the roofline gets 0.5 (its modeled latency doubles when
the profile is applied).

Solver: ``scipy.optimize.lsq_linear`` when scipy is importable (it is
not a declared dependency), else a deterministic projected-gradient
fallback in pure numpy — the problem is 3-dimensional, so a few
thousand Lipschitz-step iterations converge to machine precision.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .harvest import Sample
from .profile import CalibrationProfile, default_profile

__all__ = ["FitError", "PEAK_BOUNDS", "fit_profile", "bounded_lsq"]


class FitError(ValueError):
    """The sample set cannot support a fit."""


# Physical plausibility bounds per peak, (lower, upper).  Wide on
# purpose: they exist to keep the solver out of degenerate corners
# (θ → 0 ⇒ infinite peak), not to encode device knowledge.
PEAK_BOUNDS: Dict[str, Tuple[float, float]] = {
    "peak_flops": (1e6, 1e19),
    "hbm_bw": (1e5, 1e16),
    "ici_bw": (1e4, 1e15),
}

_EFF_CLIP = (0.05, 2.0)   # efficiency factors outside this are fit noise


def _pgd_lsq(A: np.ndarray, y: np.ndarray, lb: np.ndarray, ub: np.ndarray,
             iters: int = 20000) -> np.ndarray:
    """Projected-gradient bounded least squares (numpy fallback)."""
    AtA, Aty = A.T @ A, A.T @ y
    lip = float(np.linalg.norm(AtA, 2))
    x = np.clip(np.linalg.lstsq(A, y, rcond=None)[0], lb, ub)
    step = 1.0 / max(lip, 1e-300)
    for _ in range(iters):
        x_new = np.clip(x - step * (AtA @ x - Aty), lb, ub)
        if np.allclose(x_new, x, rtol=0.0, atol=1e-18):
            break
        x = x_new
    return x


def bounded_lsq(A: np.ndarray, y: np.ndarray, lb: np.ndarray, ub: np.ndarray,
                *, solver: str = "auto") -> Tuple[np.ndarray, str]:
    """``min ‖Ax − y‖₂  s.t. lb ≤ x ≤ ub``; returns (x, solver-used)."""
    if solver not in ("auto", "scipy", "numpy"):
        raise ValueError(f"unknown solver {solver!r}")
    if solver in ("auto", "scipy"):
        try:
            from scipy.optimize import lsq_linear
        except ImportError:
            if solver == "scipy":
                raise
        else:
            res = lsq_linear(A, y, bounds=(lb, ub), method="bvls"
                             if A.shape[0] >= A.shape[1] else "trf")
            return np.asarray(res.x, dtype=float), "scipy"
    return _pgd_lsq(A, y, lb, ub), "numpy"


def fit_profile(samples: Sequence[Sample], *, name: str,
                device: Optional[str] = None,
                prior: Optional[CalibrationProfile] = None,
                solver: str = "auto",
                provenance: Optional[Dict[str, object]] = None
                ) -> CalibrationProfile:
    """Fit a :class:`CalibrationProfile` to harvested samples.

    ``prior`` (default: the bundled analytic profile) supplies the value
    of any peak the samples cannot identify — e.g. single-host
    microbenchmarks move zero collective bytes, so the ICI peak keeps
    its prior instead of drifting to a bound.
    """
    samples = [s for s in samples
               if s.time_s > 0 and math.isfinite(s.time_s)
               and (s.flops > 0 or s.bytes > 0 or s.coll_bytes > 0)]
    if not samples:
        raise FitError("no usable samples: every record lacked timing or "
                       "carried zero work")
    prior = prior or default_profile()
    dev = device or next(
        (str(dict(s.meta).get("device")) for s in samples
         if dict(s.meta).get("device")), prior.device)

    A = np.array([[s.flops, s.bytes, s.coll_bytes] for s in samples],
                 dtype=float)
    t = np.array([s.time_s for s in samples], dtype=float)
    Aw = A / t[:, None]                       # rows in relative-error scale
    yw = np.ones_like(t)

    keys = ("peak_flops", "hbm_bw", "ici_bw")
    lb = np.array([1.0 / PEAK_BOUNDS[k][1] for k in keys])
    ub = np.array([1.0 / PEAK_BOUNDS[k][0] for k in keys])
    identifiable = np.array([bool(np.any(A[:, j] > 0)) for j in range(3)])
    prior_theta = np.array([1.0 / prior.peak_flops, 1.0 / prior.hbm_bw,
                            1.0 / prior.ici_bw])

    cols = np.flatnonzero(identifiable)
    theta = prior_theta.copy()
    used = "prior"
    if len(cols):
        sub, used = bounded_lsq(Aw[:, cols], yw, lb[cols], ub[cols],
                                solver=solver)
        theta[cols] = sub
    peaks = {k: float(1.0 / theta[j]) for j, k in enumerate(keys)}

    # -- per-op-class efficiency vs the fitted roofline ---------------------
    pred = A @ theta
    by_class: Dict[str, list] = {}
    for s, p in zip(samples, pred):
        by_class.setdefault(s.op_class, []).append(p / s.time_s)
    efficiency = {
        c: float(min(max(statistics.median(r), _EFF_CLIP[0]), _EFF_CLIP[1]))
        for c, r in sorted(by_class.items())}

    # -- residuals (relative, after class efficiency) -----------------------
    rel = np.array([
        (pred[i] / efficiency[s.op_class] - s.time_s) / s.time_s
        for i, s in enumerate(samples)])
    residuals: Dict[str, float] = {
        "rel_rmse": float(np.sqrt(np.mean(rel ** 2))),
        "rel_max_abs": float(np.max(np.abs(rel))),
        "n_samples": float(len(samples)),
    }
    for c in by_class:
        sel = np.array([s.op_class == c for s in samples])
        residuals[f"rel_rmse:{c}"] = float(np.sqrt(np.mean(rel[sel] ** 2)))

    prov: Dict[str, object] = {
        "solver": used,
        "n_samples": len(samples),
        "classes": {c: len(r) for c, r in sorted(by_class.items())},
        "identified": [k for j, k in enumerate(keys) if identifiable[j]],
        "prior": prior.name,
    }
    prov.update(provenance or {})

    return CalibrationProfile(
        name=name, device=dev,
        peak_flops=peaks["peak_flops"], hbm_bw=peaks["hbm_bw"],
        ici_bw=peaks["ici_bw"], efficiency=efficiency,
        provenance=prov, residuals=residuals).validate()
