"""Token interning: string identifiers -> dense int32 indices.

Counterpart of `sitewhere_tpu/registry/interning.py` with sequential
allocation only (what `shard_classes=1` gives there): the native C++ mirror
and the shard-congruent allocator belong to the sharded slice. Index 0 is
reserved as UNKNOWN so lookup tensors keep a sentinel row and failed
lookups stay in-band on the device.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from sitewhere_tpu_torch.errors import ErrorCode, SiteWhereError


class TokenInterner:
    """Bidirectional string <-> int32 mapping with a fixed capacity."""

    UNKNOWN = 0

    def __init__(self, capacity: int, name: str = "tokens"):
        if capacity < 2:
            raise ValueError("capacity must be >= 2")
        self.capacity = capacity
        self.name = name
        self._to_index: Dict[str, int] = {}
        self._to_token: List[Optional[str]] = [None]  # index 0 = UNKNOWN
        self._lock = threading.Lock()
        # bumped on every mutation, restore() included: a restore can swap
        # same-length contents, so length is no cache key
        self.version = 0
        self._token_array: Optional[np.ndarray] = None
        self._token_array_version = -1

    def __len__(self) -> int:
        return len(self._to_token)

    def intern(self, token: str) -> int:
        """Get-or-assign the index for a token."""
        idx = self._to_index.get(token)
        if idx is not None:
            return idx
        with self._lock:
            idx = self._to_index.get(token)
            if idx is not None:
                return idx
            idx = len(self._to_token)
            if idx >= self.capacity:
                raise SiteWhereError(
                    f"interner '{self.name}' capacity {self.capacity} "
                    f"exceeded", ErrorCode.CAPACITY_EXCEEDED)
            self._to_token.append(token)
            self._to_index[token] = idx
            self.version += 1
            return idx

    def lookup(self, token: str) -> int:
        """Index for a token, UNKNOWN (0) if absent. Never allocates."""
        return self._to_index.get(token, self.UNKNOWN)

    def token_of(self, index: int) -> Optional[str]:
        if 0 < index < len(self._to_token):
            return self._to_token[index]
        return None

    def token_array(self) -> np.ndarray:
        """Dense [capacity] object array: index -> token, "" for UNKNOWN and
        never-assigned slots. Cached until the version moves, so alert
        materialization resolves many indices with one fancy-index. Shared:
        callers must not mutate it."""
        with self._lock:
            if (self._token_array is not None
                    and self._token_array_version == self.version):
                return self._token_array
            arr = np.empty(self.capacity, object)
            arr[:] = ""
            for i in range(1, len(self._to_token)):
                if self._to_token[i] is not None:
                    arr[i] = self._to_token[i]
            self._token_array = arr
            self._token_array_version = self.version
            return arr

    def snapshot(self) -> List[Optional[str]]:
        with self._lock:
            return list(self._to_token)

    def restore(self, tokens: Sequence[Optional[str]]) -> None:
        """Rebuild from a snapshot (index 0 = UNKNOWN is added if absent)."""
        with self._lock:
            incoming = list(tokens) if tokens else [None]
            if incoming[0] is not None:
                incoming.insert(0, None)
            if len(incoming) > self.capacity:
                raise SiteWhereError(
                    f"interner '{self.name}' capacity {self.capacity} "
                    f"exceeded", ErrorCode.CAPACITY_EXCEEDED)
            self._to_token = incoming
            self._to_index = {t: i for i, t in enumerate(incoming)
                              if t is not None}
            self.version += 1
