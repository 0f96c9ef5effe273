"""Serving steps of the LM (port of ``repro.distributed``, one device)."""
