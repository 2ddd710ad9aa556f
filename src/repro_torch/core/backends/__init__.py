"""Pluggable communication backends. Importing this package registers
every ported mode; callers ask the registry and never branch on mode
names. Counterpart of ``repro/core/backends/__init__.py``; only
``gspmd`` is ported so far (the hadronio family: ROADMAP.md, Queue 1).
"""
from repro_torch.core.backends.base import (CommBackend, SyncContext,
                                            available_modes, get_backend,
                                            register)

# importing the mode modules runs their @register decorators
from repro_torch.core.backends import gspmd  # noqa: F401

__all__ = ["CommBackend", "SyncContext", "available_modes", "get_backend",
           "register"]
