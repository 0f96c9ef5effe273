"""Checkpointing (port of ``repro.checkpoint``): train state to .npz (flat
path-keyed arrays) with a metadata JSON sidecar, the DVQ-AE server state in
the reference's ``.state.npz`` layout, and the append-only JSONL journal
of crash-consistent ingest."""
from .journal import Journal, decode_array, encode_array
from .npz import (load_pytree, load_server_state, restore, save,
                  save_pytree, save_server_state)
