"""JAX-free loading of the host layer shared with the `aacjax` package.

The port reuses `aacjax`'s host modules as they are (`host/native.py`,
`adts.py`, `asc.py`, `bitio.py`, `huffman.py`, `syntax.py`, `tables.py`,
`kernels/windows.py`, `runtime/stats.py` and the `testing` encoders).  None
of them imports JAX, but importing any `aacjax.<module>` first runs
`aacjax/__init__.py`, which imports the JAX runtime.  On a machine without
JAX the loader below registers a bare package module named `aacjax` whose
`__path__` is the `aacjax/` directory, so the submodules import normally and
`aacjax/__init__.py` never runs.  Where JAX is installed the real package is
used unchanged.
"""
from __future__ import annotations

import importlib.machinery
import importlib.util
import pathlib
import sys
import types

AACJAX_DIR = pathlib.Path(__file__).resolve().parent.parent / "aacjax"


def ensure_shared() -> None:
    """Make `aacjax.<host module>` importable, without JAX if it is absent."""
    if "aacjax" in sys.modules or importlib.util.find_spec("jax") is not None:
        return
    spec = importlib.machinery.ModuleSpec("aacjax", None, is_package=True)
    spec.submodule_search_locations = [str(AACJAX_DIR)]
    pkg = types.ModuleType("aacjax")
    pkg.__spec__ = spec
    pkg.__path__ = [str(AACJAX_DIR)]
    pkg.__package__ = "aacjax"
    sys.modules["aacjax"] = pkg
