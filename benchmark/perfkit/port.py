"""The system under test: the port's configuration object built from a
configuration file (its ``preset`` with its ``overrides``).  Only the
port (``nbdistributed_tpu_torch``) is imported, and only when a cell
runs."""

from __future__ import annotations

import importlib

from .weights import DTYPES

PORT = "nbdistributed_tpu_torch"


def build_config(config: dict):
    """``config["preset"]`` (``"module:function"`` inside the port) called
    with the file's ``overrides``."""
    modname, fn = config["preset"].split(":")
    if modname.split(".")[0] != PORT:
        raise ValueError(f"a preset must live in {PORT}, got {modname}")
    kw = dict(config.get("overrides", {}))
    if "dtype" in kw:
        kw["dtype"] = DTYPES[kw["dtype"]]
    return getattr(importlib.import_module(modname), fn)(**kw)
