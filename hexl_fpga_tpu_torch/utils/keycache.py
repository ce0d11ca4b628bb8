"""Pinned, checksum-guarded device-upload cache for switch-key sets.

The reference caches packed keys per host pointer forever
(`host/src/fpga.cpp:1158-1165`); here the cache is bounded LRU, pins the
source arrays (so a recycled CPython id can never alias a dead entry), and
verifies a sampled content checksum on every hit (in-place mutation of a
cached key buffer — the one hazard pointer-keying cannot see — forces a
re-upload instead of stale results).  Shared by the single-chip keyswitch
context and the sharded path.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Sequence

import numpy as np


def sampled_checksum(arrs: Sequence[np.ndarray]) -> int:
    """Content guard for cache hits.

    Default: a fixed stride through each buffer plus the last element —
    cheap, but able to miss a mutation that avoids
    every sampled element.  The cache's primary contract is the reference's
    own (`keys_map_` is pointer-keyed with NO content check at all,
    `host/src/fpga.cpp:1158-1165`): callers must not mutate a key buffer
    in place — re-create the array instead.  The sample is a strictly
    stronger best-effort guard; set HEXL_TPU_KEY_CHECKSUM=full to hash
    every byte on every hit when that
    contract cannot be trusted."""
    import os

    full = os.environ.get("HEXL_TPU_KEY_CHECKSUM") == "full"
    h = 0
    # chain order-dependently: XOR-folding per-array hashes would cancel
    # for byte-identical (e.g. aliased) key arrays, hiding their mutations
    for a in arrs:
        flat = a.reshape(-1)
        if full:
            h = hash((h, flat.tobytes()))
        else:
            s = max(1, flat.size // 64)
            h = hash((h, flat[::s].tobytes(), flat[-1].item()))
    return h


# key sets staged (cache misses) by every PinnedKeyCache of the process, for
# chip_smoke.py and the tests to count uploads by
UPLOADS = {"key_sets": 0}
_uploads_lock = threading.Lock()


class PinnedKeyCache:
    """LRU of staged key uploads keyed by source-array identity."""

    def __init__(self, slots: int, stage: Callable):
        self.slots = slots
        self.stage = stage  # list[np.ndarray] -> staged device value
        self._cache: OrderedDict = OrderedDict()

    def get(self, k_switch_keys):
        src = [np.asarray(kv, dtype=np.uint64) for kv in k_switch_keys]
        kid = tuple(id(a) for a in src)
        entry = self._cache.get(kid)
        if entry is not None:
            pinned, csum, hit = entry
            same = len(pinned) == len(src) and all(
                p is s for p, s in zip(pinned, src)
            )
            if same and csum == sampled_checksum(src):
                self._cache.move_to_end(kid)
                return hit
            del self._cache[kid]  # mutated or aliased: re-upload
        hit = self.stage(src)
        with _uploads_lock:
            UPLOADS["key_sets"] += 1
        self._cache[kid] = (src, sampled_checksum(src), hit)
        while len(self._cache) > self.slots:
            self._cache.popitem(last=False)
        return hit
