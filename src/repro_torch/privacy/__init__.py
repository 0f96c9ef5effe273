"""Privacy evaluation (port of ``repro.privacy``): the Thm. 1 audit."""
