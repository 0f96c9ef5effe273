"""Decoder LM backbones (port of ``repro.models``)."""
