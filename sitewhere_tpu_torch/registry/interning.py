"""Token interning: string identifiers -> dense int32 indices.

Counterpart of `sitewhere_tpu/registry/interning.py` with sequential
allocation only (what `shard_classes=1` gives there): the shard-congruent
allocator and the replica journal belong to later slices. Index 0 is
reserved as UNKNOWN so lookup tensors keep a sentinel row and failed
lookups stay in-band on the device.

The batched calls (`lookup_batch`, `lookup_offsets`, `intern_batch`,
`intern_offsets`) run on the native host library's table (`native.py`),
which mirrors the Python table entry for entry. The Python side stays
authoritative for token_of / snapshot / restore. The mirror is built at the
first batched call (so an interner that never sees one never loads the
library), kept in step by every later mutation, and rebuilt by restore().
Every mutation, native ones included, bumps `version`.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence

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
        # the native mirror, built at the first batched call
        self._nat = None

    def __len__(self) -> int:
        return len(self._to_token)

    def _raise_capacity(self):
        raise SiteWhereError(
            f"interner '{self.name}' capacity {self.capacity} exceeded",
            ErrorCode.CAPACITY_EXCEEDED)

    def _mirror_sync_error(self, nidx: int, idx: int):
        # an exception, not an assert: a silent native/Python desync would
        # corrupt every later batched lookup
        raise SiteWhereError(
            f"interner '{self.name}' native mirror out of sync "
            f"(native {nidx} != {idx})", ErrorCode.GENERIC)

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
                self._raise_capacity()
            self._to_token.append(token)
            self._to_index[token] = idx
            self.version += 1
            if self._nat is not None:
                nidx = self._nat.add(token)
                if nidx != idx:
                    self._mirror_sync_error(nidx, idx)
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

    # -- the native mirror ------------------------------------------------------

    def _native(self):
        """The native mirror, built from the Python table at first use
        (caller holds self._lock)."""
        if self._nat is None:
            self._nat = self._build_native()
        return self._nat

    def _build_native(self):
        """A native table holding the Python table's slots: runs of tokens
        interned in bulk, None gaps (a shard-congruent snapshot's) as
        unfindable placeholders."""
        from sitewhere_tpu_torch import native

        nat = native.NativeInterner(self.capacity)
        tokens = self._to_token
        i = 1
        while i < len(tokens):
            if tokens[i] is None:
                if nat.add_gap() != i:
                    self._mirror_sync_error(-1, i)
                i += 1
                continue
            j = i
            while j < len(tokens) and tokens[j] is not None:
                j += 1
            buf, off = native.join_tokens(tokens[i:j])
            idx, ok = nat.intern_offsets(buf, off)
            want = np.arange(i, j, dtype=np.int32)
            if not ok or not np.array_equal(idx, want):
                bad = int(np.argmax(idx != want)) if ok else 0
                self._mirror_sync_error(int(idx[bad]), i + bad)
            i = j
        return nat

    def lookup_batch(self, tokens: Sequence[str]) -> np.ndarray:
        """Vectorized lookup of many tokens -> int32 array (no allocation)."""
        from sitewhere_tpu_torch import native

        buf, off = native.join_tokens(tokens)
        return self.lookup_offsets(buf, off)

    def lookup_offsets(self, buf: bytes, off: np.ndarray) -> np.ndarray:
        """Lookup tokens given as a (joined bytes, offsets[n+1]) pair — the
        zero-copy contract of the native wire decoder."""
        nat = self._nat
        if nat is None:
            with self._lock:
                nat = self._native()
        return nat.lookup_offsets(buf, off)

    def intern_batch(self, tokens: Iterable[str]) -> np.ndarray:
        from sitewhere_tpu_torch import native

        buf, off = native.join_tokens(list(tokens))
        return self.intern_offsets(buf, off)

    def intern_offsets(self, buf: bytes, off: np.ndarray,
                       skip_empty: bool = False) -> np.ndarray:
        """intern_batch over a (joined bytes, offsets) pair. skip_empty maps
        zero-length tokens to UNKNOWN without interning (absent fields in
        decoded columns)."""
        with self._lock:
            idx, ok = self._native().intern_offsets(buf, off, skip_empty)
            self._sync_from_native()
        if not ok:
            self._raise_capacity()
        return idx

    def _sync_from_native(self) -> None:
        """Mirror the tokens the native table assigned that Python has not
        seen (caller holds self._lock)."""
        n = len(self._nat)
        if len(self._to_token) < n:
            self.version += 1
        while len(self._to_token) < n:
            idx = len(self._to_token)
            token = self._nat.token_at(idx)
            self._to_token.append(token)
            self._to_index[token] = idx

    # -- snapshots ----------------------------------------------------------------

    def snapshot(self) -> List[Optional[str]]:
        with self._lock:
            return list(self._to_token)

    def restore(self, tokens: Sequence[Optional[str]]) -> None:
        """Rebuild from a snapshot (index 0 = UNKNOWN is added if absent);
        a native mirror is rebuilt from the restored table."""
        with self._lock:
            incoming = list(tokens) if tokens else [None]
            if incoming[0] is not None:
                incoming.insert(0, None)
            if len(incoming) > self.capacity:
                self._raise_capacity()
            self._to_token = incoming
            self._to_index = {t: i for i, t in enumerate(incoming)
                              if t is not None}
            self.version += 1
            if self._nat is not None:
                self._nat = None
                self._nat = self._build_native()
