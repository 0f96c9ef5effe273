"""Codebook registry and code store (port of ``repro.server``)."""
