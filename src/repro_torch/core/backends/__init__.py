"""Pluggable communication backends. Importing this package registers
every ported mode; callers ask the registry and never branch on mode
names. Counterpart of ``repro/core/backends/__init__.py``: all seven of
its modes are ported — ``gspmd``, the paper's baselines ``sockets`` and
``vma``, and the hadronio family ``hadronio``, ``hadronio_rs``,
``hadronio_overlap`` and ``hadronio_overlap_rs``.
"""
from repro_torch.core.backends.base import (CommBackend, StateSpecs,
                                            SyncContext, SyncResult,
                                            UpdateContext, available_modes,
                                            get_backend, register,
                                            scatter_group_size)

# importing the mode modules runs their @register decorators
from repro_torch.core.backends import gspmd        # noqa: F401
from repro_torch.core.backends import sockets      # noqa: F401
from repro_torch.core.backends import vma          # noqa: F401
from repro_torch.core.backends import hadronio     # noqa: F401
from repro_torch.core.backends import hadronio_rs  # noqa: F401
from repro_torch.core.backends import hadronio_overlap     # noqa: F401
from repro_torch.core.backends import hadronio_overlap_rs  # noqa: F401

__all__ = ["CommBackend", "StateSpecs", "SyncContext", "SyncResult",
           "UpdateContext", "available_modes", "get_backend", "register",
           "scatter_group_size"]
