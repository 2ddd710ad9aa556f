"""Pluggable communication backends. Importing this package registers
every ported mode; callers ask the registry and never branch on mode
names. Counterpart of ``repro/core/backends/__init__.py``; ``gspmd``,
``sockets``, ``vma`` and ``hadronio`` are ported (the rest of the
hadronio family: ROADMAP.md Queue 1 item 4).
"""
from repro_torch.core.backends.base import (CommBackend, StateSpecs,
                                            SyncContext, SyncResult,
                                            UpdateContext, available_modes,
                                            get_backend, register)

# importing the mode modules runs their @register decorators
from repro_torch.core.backends import gspmd        # noqa: F401
from repro_torch.core.backends import sockets      # noqa: F401
from repro_torch.core.backends import vma          # noqa: F401
from repro_torch.core.backends import hadronio     # noqa: F401

__all__ = ["CommBackend", "StateSpecs", "SyncContext", "SyncResult",
           "UpdateContext", "available_modes", "get_backend", "register"]
