"""Plugin and action registries (pkg/scheduler/framework/plugins.go)."""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

_lock = threading.Lock()
_plugin_builders: Dict[str, Callable] = {}
_actions: Dict[str, object] = {}


def register_plugin_builder(name: str, builder: Callable) -> None:
    with _lock:
        _plugin_builders[name] = builder


def get_plugin_builder(name: str) -> Optional[Callable]:
    with _lock:
        return _plugin_builders.get(name)


def register_action(action) -> None:
    with _lock:
        _actions[action.name] = action


def get_action(name: str):
    with _lock:
        return _actions.get(name)


def list_actions():
    with _lock:
        return dict(_actions)
