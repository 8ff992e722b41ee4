"""Token interning: string identifiers -> dense int32 indices.

Counterpart of `sitewhere_tpu/registry/interning.py`. Index 0 is reserved
as UNKNOWN so lookup tensors keep a sentinel row and failed lookups stay
in-band on the device.

`shard_classes` > 1 turns on shard-congruent allocation, as the reference's
does: a token's index is chosen within its congruence class `crc32(token) %
classes`, so the sharded engine's ownership `idx % S` depends only on the
token, never on creation order. The table becomes sparse: gap slots are
None (unfindable placeholders in the native mirror, overwritten in place by
`set_at` when their class reaches them) and journal as (idx, None).
Congruent interning goes token by token (the native bulk assign is
sequential only). classes == 1 is the sequential allocator.

The batched calls (`lookup_batch`, `lookup_offsets`, `intern_batch`,
`intern_offsets`) run on the native host library's table (`native.py`),
which mirrors the Python table entry for entry. The Python side stays
authoritative for token_of / snapshot / restore. The mirror is built at the
first batched call (so an interner that never sees one never loads the
library), kept in step by every later mutation, and rebuilt by restore().
Every mutation, native ones included, bumps `version`.

The replica journal (`journal_len`, `journal_since`, `apply_delta`,
`journal_epoch`) is the reference's: one (idx, token) entry per slot
assignment in index order, a gap slot as (idx, None), so a feeder's replica
(feeders/replica.py) that replays it packs the same indices. restore()
rebuilds it and bumps `journal_epoch`.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from sitewhere_tpu_torch.errors import ErrorCode, SiteWhereError


class TokenInterner:
    """Bidirectional string <-> int32 mapping with a fixed capacity."""

    UNKNOWN = 0

    def __init__(self, capacity: int, name: str = "tokens",
                 shard_classes: int = 1):
        if capacity < 2:
            raise ValueError("capacity must be >= 2")
        if shard_classes < 1 or shard_classes >= capacity:
            raise ValueError("shard_classes must be in [1, capacity)")
        self.capacity = capacity
        self.name = name
        self.shard_classes = shard_classes
        # per-class next candidate index (class 0 starts past UNKNOWN)
        self._class_next: Dict[int, int] = {}
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
        # append-only assignment journal for replicas (see the module
        # docstring); replaying it from 0 reproduces _to_token
        self._journal: List[tuple] = []
        self.journal_epoch = 0

    def __len__(self) -> int:
        return len(self._to_token)

    def _raise_capacity(self, congruence_class: Optional[int] = None):
        if congruence_class is not None:
            # a class can run out while the table is mostly empty (crc32
            # skew): name the real limit
            per_class = self.capacity // self.shard_classes
            raise SiteWhereError(
                f"interner '{self.name}' congruence class "
                f"{congruence_class} exhausted (~{per_class} slots per "
                f"class = capacity {self.capacity} / {self.shard_classes} "
                f"shard classes; raise max_devices)",
                ErrorCode.CAPACITY_EXCEEDED)
        raise SiteWhereError(
            f"interner '{self.name}' capacity {self.capacity} exceeded",
            ErrorCode.CAPACITY_EXCEEDED)

    def _mirror_sync_error(self, nidx: int, idx: int):
        # an exception, not an assert: a silent native/Python desync would
        # corrupt every later batched lookup
        raise SiteWhereError(
            f"interner '{self.name}' native mirror out of sync "
            f"(native {nidx} != {idx})", ErrorCode.GENERIC)

    def _class_of(self, token: str) -> int:
        import zlib

        return zlib.crc32(token.encode(errors="surrogateescape")) \
            % self.shard_classes

    def _intern_congruent(self, token: str) -> int:
        """Assign within the token's congruence class (caller holds the
        lock): the class's next free slot, filling a gap in place or
        appending gaps up to it."""
        cls = self._class_of(token)
        start = cls if cls != 0 else self.shard_classes
        idx = self._class_next.get(cls, start)
        # skip slots already occupied (a restored snapshot's)
        while idx < len(self._to_token) and self._to_token[idx] is not None:
            idx += self.shard_classes
        if idx >= self.capacity:
            self._raise_capacity(congruence_class=cls)
        if idx < len(self._to_token):
            # a gap left by another class growing past: fill it in place
            self._to_token[idx] = token
            if self._nat is not None and self._nat.set_at(idx, token) != 0:
                self._mirror_sync_error(-1, idx)
        else:
            while len(self._to_token) < idx:
                gap = len(self._to_token)
                self._to_token.append(None)
                self._journal.append((gap, None))
                if self._nat is not None and self._nat.add_gap() != gap:
                    self._mirror_sync_error(-1, gap)
            self._to_token.append(token)
            if self._nat is not None:
                nidx = self._nat.add(token)
                if nidx != idx:
                    self._mirror_sync_error(nidx, idx)
        self._journal.append((idx, token))
        self._to_index[token] = idx
        self._class_next[cls] = idx + self.shard_classes
        self.version += 1
        return idx

    def intern(self, token: str) -> int:
        """Get-or-assign the index for a token."""
        idx = self._to_index.get(token)
        if idx is not None:
            return idx
        with self._lock:
            idx = self._to_index.get(token)
            if idx is not None:
                return idx
            if self.shard_classes > 1:
                return self._intern_congruent(token)
            idx = len(self._to_token)
            if idx >= self.capacity:
                self._raise_capacity()
            self._to_token.append(token)
            self._to_index[token] = idx
            self._journal.append((idx, token))
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

        if self.shard_classes > 1:
            return np.fromiter((self.intern(t) for t in tokens),
                               dtype=np.int32)
        buf, off = native.join_tokens(list(tokens))
        return self.intern_offsets(buf, off)

    def intern_offsets(self, buf: bytes, off: np.ndarray,
                       skip_empty: bool = False) -> np.ndarray:
        """intern_batch over a (joined bytes, offsets) pair. skip_empty maps
        zero-length tokens to UNKNOWN without interning (absent fields in
        decoded columns)."""
        if self.shard_classes > 1:
            n = len(off) - 1

            def one(i):
                if skip_empty and off[i + 1] == off[i]:
                    return 0
                return self.intern(
                    buf[off[i]:off[i + 1]].decode(errors="surrogateescape"))

            return np.fromiter((one(i) for i in range(n)), dtype=np.int32,
                               count=n)
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
            self._journal.append((idx, token))

    # -- the replica journal (feeders/replica.py) -------------------------------

    def journal_len(self) -> int:
        with self._lock:
            return len(self._journal)

    def journal_since(self, n: int) -> tuple:
        """(journal_epoch, entries[n:]): the delta a replica at journal
        position `n` needs. A replica whose remembered epoch differs
        discards its table and resyncs from 0 (this interner was
        restored)."""
        with self._lock:
            return self.journal_epoch, list(self._journal[n:])

    def apply_delta(self, entries: Sequence[tuple], base: int) -> int:
        """Replay journal entries [base, base + len) onto this interner (a
        replica), by explicit index: appended gaps and in-place fills
        reproduce the authoritative table. Raises on a positional mismatch
        or a slot conflict (the replica must resync). Returns the new
        journal length."""
        with self._lock:
            if base != len(self._journal):
                raise SiteWhereError(
                    f"interner '{self.name}' delta base {base} != replica "
                    f"journal {len(self._journal)} (resync required)",
                    ErrorCode.GENERIC)
            mutated = False
            for idx, token in entries:
                idx = int(idx)
                if idx >= self.capacity:
                    self._raise_capacity()
                while len(self._to_token) <= idx:
                    self._to_token.append(None)
                    if self._nat is not None and \
                            self._nat.add_gap() != len(self._to_token) - 1:
                        self._mirror_sync_error(-1, len(self._to_token) - 1)
                cur = self._to_token[idx]
                if token is None:
                    if cur is not None:
                        raise SiteWhereError(
                            f"interner '{self.name}' delta gap at occupied "
                            f"slot {idx} ({cur!r})", ErrorCode.GENERIC)
                elif cur is None:
                    self._to_token[idx] = token
                    self._to_index[token] = idx
                    if self._nat is not None and \
                            self._nat.set_at(idx, token) != 0:
                        self._mirror_sync_error(-1, idx)
                    if self.shard_classes > 1:
                        cls = idx % self.shard_classes
                        self._class_next[cls] = max(
                            self._class_next.get(cls, 0),
                            idx + self.shard_classes)
                    mutated = True
                elif cur != token:
                    raise SiteWhereError(
                        f"interner '{self.name}' delta conflict at slot "
                        f"{idx}: {cur!r} != {token!r} (resync required)",
                        ErrorCode.GENERIC)
                self._journal.append((idx, token))
            if mutated:
                self.version += 1
            return len(self._journal)

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
            if self.shard_classes > 1:
                # a snapshot of another layout would break ownership (idx
                # % S must equal crc32(token) % S): refuse, validated
                # before anything is swapped
                bad = [t for i, t in enumerate(incoming)
                       if t is not None and i > 0
                       and i % self.shard_classes != self._class_of(t)]
                if bad:
                    raise ValueError(
                        f"interner '{self.name}' snapshot is not "
                        f"congruent with {self.shard_classes} shard "
                        f"classes ({len(bad)} tokens at non-congruent "
                        f"indices, e.g. {bad[0]!r}); it was taken on a "
                        f"different shard layout — restore it onto the "
                        f"original layout, or re-provision")
            self._to_token = incoming
            self._to_index = {t: i for i, t in enumerate(incoming)
                              if t is not None}
            # the journal no longer describes the table: rebuild it as the
            # snapshot's slots and bump the epoch, so replicas resync
            self._journal = [(i, t) for i, t in enumerate(incoming) if i > 0]
            self.journal_epoch += 1
            # the congruent allocator resumes each class past its max
            self._class_next = {}
            if self.shard_classes > 1:
                for idx, token in enumerate(incoming):
                    if token is not None and idx > 0:
                        cls = idx % self.shard_classes
                        self._class_next[cls] = max(
                            self._class_next.get(cls, 0),
                            idx + self.shard_classes)
            self.version += 1
            if self._nat is not None:
                self._nat = None
                self._nat = self._build_native()
