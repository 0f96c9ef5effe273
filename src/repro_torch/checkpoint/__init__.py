"""Train-state checkpointing to .npz (flat path-keyed arrays) + a metadata
JSON sidecar (port of ``repro.checkpoint``'s npz half; the journal is
ROADMAP Queue 1)."""
from .npz import load_pytree, restore, save, save_pytree
