"""Codebook version registry (Step 5 bookkeeping for the server).

Port of ``repro.server.registry`` without the migration windows, which
come with the server-runtime slice. Every merged dictionary is pinned as
an immutable snapshot under a monotonically increasing version, so each
payload decodes against exactly the table it was packed under.
"""
from __future__ import annotations

from typing import Dict, Set, Tuple

import torch

from repro_torch.core import octopus as OC


class CodebookRegistry:
    """Immutable (K, M) codebook snapshots, one per merge."""

    def __init__(self, codebook: torch.Tensor):
        self._versions: Dict[int, torch.Tensor] = {0: codebook.clone()}
        self.latest = 0
        self._retired: Set[int] = set()

    def __len__(self) -> int:
        return len(self._versions)

    def __contains__(self, version: int) -> bool:
        return int(version) in self._versions

    def get(self, version: int) -> torch.Tensor:
        """Snapshot for ``version``; KeyError if it was never registered."""
        return self._versions[int(version)]

    @property
    def current(self) -> torch.Tensor:
        return self._versions[self.latest]

    def register(self, codebook: torch.Tensor) -> int:
        """Pin a new global dictionary; returns its version number."""
        self.latest += 1
        self._versions[self.latest] = codebook.clone()
        return self.latest

    def pin_current(self, codebook: torch.Tensor) -> int:
        """Replace the LATEST snapshot in place (no new version)."""
        self._versions[self.latest] = codebook.clone()
        return self.latest

    def is_retired(self, version: int) -> bool:
        return int(version) in self._retired

    def merge(self, server: OC.ServerState, client_codebooks, client_counts,
              *, client_versions=None, staleness_decay: float = 1.0
              ) -> Tuple[OC.ServerState, int]:
        """Staleness-weighted Step 5 merge, then registration of the merged
        dictionary. ``client_versions``: the registry version each client
        last deployed from; staleness ``max(latest - version, 0)``
        discounts its counts by ``staleness_decay ** staleness`` (only
        when the decay is not 1). Returns (merged state, new version)."""
        staleness = None
        if client_versions is not None and staleness_decay != 1.0:
            staleness = (self.latest - torch.as_tensor(
                client_versions, dtype=torch.int32)).clamp(min=0)
        merged = OC.server_merge_codebooks(
            server, client_codebooks, client_counts, staleness=staleness,
            staleness_decay=staleness_decay)
        return merged, self.register(merged.params["codebook"])
