"""Shared helpers of the exploration-plane parity tests
(tests/test_torch_explore*.py, tests/test_torch_obs_cli.py): run one CLI
``main`` of either package in a directory of its own, and mask the fields
that measure the run (wall time, worker count) rather than what it
computed.

The reference's explore, obs and calibrate CLIs never import jax, so the
tests import them as the JAX package's own tests do; each package builds
its workloads from its own classes.
"""
from __future__ import annotations

import re
from pathlib import Path

ENGINE_TIME = re.compile(r"evaluated on \d+ worker\(s\) in [0-9.]+s")
JSON_WALL = re.compile(r'"(wall_s|workers)": [0-9.eE+-]+')


def mask_stdout(text: str) -> str:
    """The ``engine:`` line's wall time and worker count, masked."""
    return ENGINE_TIME.sub("evaluated on ? worker(s) in ?s", text)


def mask_json(text: str) -> str:
    """A result JSON's ``wall_s`` and ``workers`` stats, masked."""
    return JSON_WALL.sub(r'"\1": ?', text)


def run_cli(main, argv, workdir: Path, capsys, monkeypatch):
    """``main(argv)`` run from ``workdir`` (made if missing): its exit
    code, its standard output and the files it wrote, by relative path."""
    workdir.mkdir(parents=True, exist_ok=True)
    capsys.readouterr()
    with monkeypatch.context() as m:
        m.chdir(workdir)
        rc = main(list(argv))
    out = capsys.readouterr().out
    files = {str(p.relative_to(workdir)): p.read_bytes()
             for p in sorted(workdir.rglob("*")) if p.is_file()}
    return rc, out, files
