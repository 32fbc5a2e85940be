"""Replicated, versioned distributed file store (the reference's SDFS).

Three pieces:
- `local_store`: each node's on-disk versioned store
  (reference file_service.py)
- `metadata`: the leader's global file table, placement, and
  re-replication planning (reference leader.py)
- `data_plane`: TCP stream transfers between nodes, replacing the
  reference's scp-over-SSH with password files
  (reference file_service.py:52-91, config.py:29-37)
"""

from .local_store import CorruptionError, DiskFault, LocalStore  # noqa: F401
from .metadata import StoreMetadata  # noqa: F401
from .data_plane import DataPlane  # noqa: F401
