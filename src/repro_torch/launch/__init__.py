"""Command-line drivers (port of ``repro.launch``)."""
