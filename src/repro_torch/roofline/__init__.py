"""Roofline accounting of the port: per-rank op counts
(:mod:`.op_analysis`) and the terms they give on one H100
(:mod:`.analysis`)."""
