"""Calibration profiles: measured roofline parameters as data.

Copy of ``repro.calibrate.profile``: the port never imports the JAX package.

A :class:`CalibrationProfile` is the contract between the measurement
plane (dry-run ledgers + kernel microbenchmarks, :mod:`.harvest`) and
the consumers that price work against a device:

* :mod:`repro_torch.launch.roofline` resolves its per-chip peaks from a
  profile instead of module constants;
* :func:`repro_torch.core.costmodel.simulate` optionally scales op
  latency by the profile's per-op-class efficiency factors.

Profiles are schema-versioned JSON documents with provenance (where the
samples came from) and fit residuals (how well the roofline explains
them), and are persisted content-addressed — the filename embeds a
digest of the physical parameters, so two fits that agree land on the
same file and a changed fit never silently shadows an old one.

This module is stdlib-only on purpose, as the reference's: what merely
*reads* a profile (the roofline) needs neither torch nor numpy.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
from pathlib import Path
from typing import Dict, Optional, Union

__all__ = [
    "SCHEMA_VERSION", "DEFAULT_PROFILE_NAME", "ProfileError",
    "CalibrationProfile", "default_profile", "resolve_profile",
    "bundled_profiles_dir",
]

SCHEMA_VERSION = 1

# The reference's analytic default profile, kept as data: ``profile=None``
# and the bundled default must give the same report, bit for bit, in the
# port and in the reference.  These constants are no measurement of any
# device the port runs on.
DEFAULT_PROFILE_NAME = "tpu-v5e-analytic"
_DEFAULT_PEAK_FLOPS = 197e12
_DEFAULT_HBM_BW = 819e9
_DEFAULT_ICI_BW = 50e9


class ProfileError(ValueError):
    """A profile document failed schema validation."""


def _positive(name: str, v) -> float:
    if not isinstance(v, (int, float)) or isinstance(v, bool) \
            or not math.isfinite(v) or v <= 0:
        raise ProfileError(f"profile field {name!r} must be a finite "
                           f"positive number, got {v!r}")
    return float(v)


@dataclasses.dataclass(frozen=True)
class CalibrationProfile:
    """Measured (or analytic) roofline parameters for one device class.

    ``peak_flops`` / ``hbm_bw`` / ``ici_bw`` are per-chip peaks in
    FLOP/s, bytes/s and bytes/s/link.  ``efficiency`` maps an op-class
    name (``"matmul"``, ``"attention"``, ``"post_proc"``, ...) to the
    fraction of the fitted roofline that class actually achieves —
    1.0 means the class sits on the roofline, 0.5 means it runs at half
    of it (latency doubles).  ``provenance`` records where the fit's
    samples came from; ``residuals`` records per-class relative fit
    error.  Both are informational: they travel with the profile but do
    not enter :meth:`content_hash`.
    """

    name: str
    device: str
    peak_flops: float = _DEFAULT_PEAK_FLOPS
    hbm_bw: float = _DEFAULT_HBM_BW
    ici_bw: float = _DEFAULT_ICI_BW
    efficiency: Dict[str, float] = dataclasses.field(default_factory=dict)
    provenance: Dict[str, object] = dataclasses.field(default_factory=dict)
    residuals: Dict[str, float] = dataclasses.field(default_factory=dict)
    schema_version: int = SCHEMA_VERSION

    # -- validation ---------------------------------------------------------
    def validate(self) -> "CalibrationProfile":
        if self.schema_version != SCHEMA_VERSION:
            raise ProfileError(
                f"unsupported profile schema_version={self.schema_version!r} "
                f"(this build reads version {SCHEMA_VERSION})")
        if not self.name or not isinstance(self.name, str):
            raise ProfileError(f"profile name must be a non-empty string, "
                               f"got {self.name!r}")
        if not isinstance(self.device, str):
            raise ProfileError(f"profile device must be a string, "
                               f"got {self.device!r}")
        _positive("peak_flops", self.peak_flops)
        _positive("hbm_bw", self.hbm_bw)
        _positive("ici_bw", self.ici_bw)
        if not isinstance(self.efficiency, dict):
            raise ProfileError("efficiency must be a dict of op-class → "
                               f"factor, got {type(self.efficiency).__name__}")
        for k, v in self.efficiency.items():
            _positive(f"efficiency[{k!r}]", v)
            if v > 4.0:
                raise ProfileError(
                    f"efficiency[{k!r}]={v} is implausible (> 4× the fitted "
                    "roofline); the fit is broken or the sample mislabelled")
        return self

    # -- lookups ------------------------------------------------------------
    def efficiency_for(self, op_class: str) -> float:
        """Efficiency factor for an op class; unknown classes ride the
        roofline (1.0) so an uncalibrated class never shifts results."""
        return float(self.efficiency.get(op_class, 1.0))

    def is_analytic_default(self) -> bool:
        """True when the physical content matches the shipped analytic
        numbers exactly (i.e. applying it is a no-op)."""
        return (self.peak_flops == _DEFAULT_PEAK_FLOPS
                and self.hbm_bw == _DEFAULT_HBM_BW
                and self.ici_bw == _DEFAULT_ICI_BW
                and all(v == 1.0 for v in self.efficiency.values()))

    # -- (de)serialisation --------------------------------------------------
    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "CalibrationProfile":
        if not isinstance(d, dict):
            raise ProfileError(f"profile document must be a JSON object, "
                               f"got {type(d).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ProfileError(f"unknown profile fields: {sorted(unknown)}")
        missing = {"name", "device"} - set(d)
        if missing:
            raise ProfileError(f"profile missing required fields: "
                               f"{sorted(missing)}")
        return cls(**d).validate()

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    def save(self, path: Union[str, Path]) -> Path:
        path = Path(path)
        if path.parent and str(path.parent) not in (".", ""):
            os.makedirs(path.parent, exist_ok=True)
        path.write_text(self.to_json())
        return path

    @classmethod
    def load(cls, path: Union[str, Path]) -> "CalibrationProfile":
        try:
            doc = json.loads(Path(path).read_text())
        except (OSError, json.JSONDecodeError) as e:
            raise ProfileError(f"cannot read profile {path}: {e}") from e
        return cls.from_dict(doc)

    # -- content addressing -------------------------------------------------
    def content_hash(self) -> str:
        """Digest over the *physical* parameters only.

        Name, device, provenance and residuals are metadata about where
        the numbers came from; two fits that land on the same peaks and
        efficiencies are the same profile for every consumer — they must
        share an address (and a sweep-cache key, see
        ``repro.explore.job.canonical``).
        """
        payload = json.dumps(
            ["calibration-profile", self.schema_version,
             repr(float(self.peak_flops)), repr(float(self.hbm_bw)),
             repr(float(self.ici_bw)),
             sorted((k, repr(float(v))) for k, v in self.efficiency.items())],
            separators=(",", ":"), sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()

    def save_addressed(self, profiles_dir: Union[str, Path]) -> Path:
        """Persist under ``<dir>/<name>-<hash12>.json`` (content-addressed)."""
        digest = self.content_hash()[:12]
        return self.save(Path(profiles_dir) / f"{self.name}-{digest}.json")


# ---------------------------------------------------------------------------
# Bundled default + resolution
# ---------------------------------------------------------------------------

def bundled_profiles_dir() -> Path:
    return Path(__file__).resolve().parent / "profiles"


def default_profile() -> CalibrationProfile:
    """The bundled analytic profile (the reference's analytic default
    profile), loaded from the packaged JSON so the offline path and the
    file format exercise the same code."""
    path = bundled_profiles_dir() / "default.json"
    try:
        prof = CalibrationProfile.load(path)
    except ProfileError:
        # Source checkout without package data (or a mangled install):
        # fall back to the in-code twin of the same numbers.
        prof = CalibrationProfile(name=DEFAULT_PROFILE_NAME,
                                  device="tpu-v5e (analytic)")
    if not prof.is_analytic_default():
        raise ProfileError(
            "bundled default.json no longer matches the analytic constants; "
            "default-profile output would silently shift")
    return prof


def resolve_profile(spec: Union[None, str, Path, CalibrationProfile]
                    ) -> CalibrationProfile:
    """Turn a CLI-ish profile spec into a profile.

    ``None`` or ``"default"`` → the bundled analytic profile; a
    :class:`CalibrationProfile` passes through; anything else is a path.
    """
    if spec is None or (isinstance(spec, str) and spec == "default"):
        return default_profile()
    if isinstance(spec, CalibrationProfile):
        return spec.validate()
    return CalibrationProfile.load(spec)
