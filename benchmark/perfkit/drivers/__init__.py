"""Drivers: one module per kind of traffic (``"driver"`` in a mix file).

A driver exposes ``CHIPS``, the numbers of chips of the cells it runs,
and ``run(ctx) -> dict`` with the keys ``record`` (what the metric
readers read), ``correct``, ``checks`` (``{name: {"value", "limit"}}``),
``attempted``, ``failed`` and ``memory_peak_bytes`` (of the fullest
chip).  The runner hands ``run`` the first card; a driver of several
chips starts and stops its own processes on the others.
"""
