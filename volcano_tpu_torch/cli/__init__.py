"""vtpuctl: the framework CLI (pkg/cli + cmd/cli in the reference)."""

from .main import main

__all__ = ["main"]
