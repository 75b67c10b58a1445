"""Keeps JAX and the JAX package out of a run.

Names are compared by their whole top-level part (the text before the first
dot), so `impg_tpu_torch` passes while `impg_tpu` and `impg_tpu.cli` do not.
"""

from __future__ import annotations

import sys

BLOCKED = ("jax", "jaxlib", "flax", "impg_tpu")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def is_blocked(name: str) -> bool:
    return top_level(name) in BLOCKED


class ImportGuard:
    """Meta-path finder that refuses every blocked module and records each
    try."""

    def __init__(self):
        self.tried: list[str] = []

    def find_spec(self, name, path=None, target=None):
        if is_blocked(name):
            self.tried.append(name)
            raise ImportError(f"portbench: import of {name} refused")
        return None

    def install(self) -> "ImportGuard":
        sys.meta_path.insert(0, self)
        return self


def loaded_blocked(modules=None) -> list[str]:
    """Blocked modules present in `modules` (default sys.modules)."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m, mod in list(mods.items())
                  if mod is not None and is_blocked(m))
