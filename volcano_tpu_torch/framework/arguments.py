"""Typed plugin/action argument helpers (framework/arguments.go)."""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

log = logging.getLogger(__name__)


class Arguments(dict):
    """String->string argument map with lenient typed getters."""

    def get_int(self, key: str, default: int) -> int:
        raw = self.get(key)
        if raw in (None, ""):
            return default
        try:
            return int(raw)
        except (TypeError, ValueError):
            log.warning("Could not parse argument %r for key %s", raw, key)
            return default

    def get_float(self, key: str, default: float) -> float:
        raw = self.get(key)
        if raw in (None, ""):
            return default
        try:
            return float(raw)
        except (TypeError, ValueError):
            log.warning("Could not parse argument %r for key %s", raw, key)
            return default

    def get_str(self, key: str, default: str) -> str:
        raw = self.get(key)
        if raw in (None, ""):
            return default
        return str(raw)

    def get_bool(self, key: str, default: bool) -> bool:
        raw = self.get(key)
        if raw in (None, ""):
            return default
        if isinstance(raw, bool):
            return raw
        s = str(raw).strip().lower()
        if s in ("true", "1", "yes"):
            return True
        if s in ("false", "0", "no"):
            return False
        log.warning("Could not parse argument %r for key %s", raw, key)
        return default


def get_action_args(configurations: List["Configuration"], action: str) -> Optional[Arguments]:
    """Per-action configuration lookup (GetArgOfActionFromConf)."""
    for c in configurations:
        if c.name == action:
            return Arguments(c.arguments)
    return None


# Late import type for annotation only.
from .conf import Configuration  # noqa: E402
