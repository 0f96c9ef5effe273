"""The OCTOPUS wire: the versioned code carrier, its fused decode, and the
client/server session facades (port of ``repro.wire``)."""
