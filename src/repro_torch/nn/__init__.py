"""Base layers (port of ``repro.nn``)."""
