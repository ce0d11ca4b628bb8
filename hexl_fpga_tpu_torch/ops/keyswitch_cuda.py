"""KeySwitch on the card: hand-written NTT kernels composed with torch glue.

The counterpart of `hexl_fpga_tpu/ops/keyswitch_tpu.py` (`KeySwitchTpuContext`,
default schedule: separate deferred-quotient MAC, fused tail).  Per batch of B
ops at (n, L decomp moduli, K key moduli, 2 key components):

  INTT1            one ntt_inv per decomp modulus over (B, n)         L launches
  special engine   ntt_fwd of the stacked INTT1 outputs (L*B, n) under
                   q_k, MAC against the keys, Barrett, ntt_inv over
                   (2B, n), +q_k/2                                  1 + 1 launches
  decomp engines   ntt_fwd of the same stack under q_j, MAC          L launches
  tails            ntt_fwd_tail per decomp modulus over (2B, n)      L launches

The stacked INTT1 outputs feed every engine UNREDUCED: ntt_fwd reduces any
u64 on load, so the Barrett passes in front of each engine fold into the
kernels.  The MAC glue, the special engine's Barrett and the +q_k/2 are plain
torch ops on int64 bit patterns, as they are XLA-composed in the reference.

Values live on the device as one int64 bit pattern per u64; there are no
(lo, hi) planes, no row padding to a tile and no interleaved staging entry —
those exist in the reference for its target's sake.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Sequence

import numpy as np
import torch

from . import nt, ntt_cuda, twiddles, word64 as w

_NOT_PORTED = "not ported yet"


class KeySwitchContext:
    """KeySwitch for one static configuration on one device.

    Same fence semantics as the reference scheduler: keyed by
    (n, decomp, key_modulus, rns, components, moduli, twiddles)."""

    def __init__(
        self,
        n: int,
        decomp_modulus_size: int,
        key_modulus_size: int,
        rns_modulus_size: int,
        key_component_count: int,
        moduli: Sequence[int],
        twiddle_factors: Optional[np.ndarray] = None,
        device="cuda",
        fused_mac: bool = False,
        fused_tail: bool = True,
        plain_modulus: Optional[int] = None,
        mac_impl: str = "deferred",
    ):
        assert key_component_count == 2, "key_component_count must be 2"
        # rns_modulus_size is fence-only metadata in the reference: accept any
        # positive value, compute from (n, decomp, key_modulus, comp) alone
        assert rns_modulus_size > 0, "requires rns_modulus_size > 0"
        assert mac_impl in ("deferred", "exact128"), mac_impl
        if plain_modulus is not None:
            raise NotImplementedError(f"plain_modulus (BGV tail): {_NOT_PORTED}")
        if fused_mac:
            raise NotImplementedError(f"fused_mac=True: {_NOT_PORTED}")
        if mac_impl != "deferred":
            raise NotImplementedError(f"mac_impl={mac_impl!r}: {_NOT_PORTED}")
        if not fused_tail:
            raise NotImplementedError(f"fused_tail=False: {_NOT_PORTED}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "KeySwitchContext(device='cuda'): no CUDA device is available; "
                "pass device='cpu' to run the plain versions"
            )
        self.n = n
        self.L = decomp_modulus_size
        self.K = key_modulus_size
        self.comp = key_component_count
        self.moduli = tuple(int(m) for m in moduli)
        assert self.K - 1 >= self.L, "special modulus must not be a decomp modulus"
        # 2n-th roots: derived from the caller's tables when provided
        # (fwd[bit_reverse(1)] = psi), else the canonical minimal root
        if twiddle_factors is not None:
            view = twiddles.decode_keyswitch_twiddles(twiddle_factors, n, self.K)
            self.psi = [int(view.fwd[j][n // 2]) for j in range(self.K)]
        else:
            self.psi = [None] * self.K
        self.qk = self.moduli[self.K - 1]
        self.qk_half = self.qk >> 1
        self.q_barr = [nt.barrett_factor(1, 64, q) for q in self.moduli]
        self._fix = [
            self.moduli[j] - (self.qk_half % self.moduli[j])
            for j in range(self.L)
        ]
        # tables only for the moduli the schedule transforms under: the decomp
        # moduli and the special prime
        self._tabs = {
            j: ntt_cuda.modulus_tables(n, self.moduli[j], self.psi[j],
                                       self.device)
            for j in (*range(self.L), self.K - 1)
        }

    # -- device body ---------------------------------------------------------

    @staticmethod
    def _mac_term(val, key, kp):
        """Harvey lazy MAC terms with the APPROXIMATE quotient and the Q*q
        subtraction DEFERRED across the sum: returns (key*val mod 2^64, Q)
        per term; sum both over the source limbs and close once."""
        return w.mullo64(key, val), w.mulhi64_approx(val, kp)

    @staticmethod
    def _mac_close(wx_sum, q_sum, q):
        """(sum wx mod 2^64, sum Q) -> the lazy u64 sum.  Exact because the
        true value sum(w_i x_i - Q_i q) is a sum of [0, 4q) terms, < 28q
        < 2^58 for q <= 2^52 and L <= 7, so mod-2^64 arithmetic is lossless."""
        return w.sub64(wx_sum, w.mullo64(q_sum, q))

    def _engine_acc(self, j, stack, t, keys, kp, skip_t_term):
        """Lazy MAC sums (comp, B, n), < 28q, for engine modulus j."""
        L, n = self.L, self.n
        B = t.shape[0]
        val = ntt_cuda.ntt_fwd(stack, self._tabs[j]).view(L, B, n)
        if skip_t_term:
            # identity limb i == j: INTT_q then NTT_q is the identity on
            # canonical inputs — its MAC term comes from t_target directly
            # (val is this engine's own buffer: updated in place)
            val[j] = t[:, j, :]
        val = val[:, None]  # (L, 1, B, n)
        key = keys[:, :, j, None, :]  # (L, comp, 1, n)
        pre = kp[:, :, j, None, :]
        wx, Q = self._mac_term(val, key, pre)  # (L, comp, B, n)
        return self._mac_close(wx.sum(0), Q.sum(0), self.moduli[j])

    def _tail_j(self, j, e, acc, res, msf):
        """Per-decomp-modulus tail: e (comp*B, n) canonical under q_k, lazy
        MAC sums acc (comp, B, n), caller rows res (B, comp, L, n) ->
        (B, comp, n) output rows.  One kernel."""
        comp, n = self.comp, self.n
        B = res.shape[0]
        res_j = res[:, :, j, :].transpose(0, 1).reshape(comp * B, n).contiguous()
        out = ntt_cuda.ntt_fwd_tail(
            e, acc.view(comp * B, n), res_j, self._tabs[j], self._fix[j],
            int(msf[j, 0]), int(msf[j, 1]),
        )
        return out.view(comp, B, n).transpose(0, 1)

    def _build(self, t, keys, kp, res, msf):
        """t: (B, L, n); keys + key precons: (L, comp, K, n);
        res: (B, comp, L, n) — int64 bit patterns on self.device.
        msf: (K, 2) u64 HOST array of [reduced modswitch factor, its Harvey
        precon] rows — they become kernel scalar arguments.
        Returns (B, comp, L, n)."""
        L, K = self.L, self.K
        sp = K - 1
        qk = self.qk

        # INTT1 per decomp modulus (batch B each), stacked (L*B, n)
        stack = torch.cat([
            ntt_cuda.ntt_inv(t[:, i, :].contiguous(), self._tabs[i])
            for i in range(L)
        ])

        # ---- special engine first (engine K-1 + INTT2) ----
        acc_sp = self._engine_acc(sp, stack, t, keys, kp, False)
        acc_sp = w.barrett_reduce64(acc_sp, qk, self.q_barr[sp])
        # INTT2 over both components in one call
        d = ntt_cuda.ntt_inv(acc_sp.view(-1, self.n), self._tabs[sp])
        e = w.add_mod(d, self.qk_half, qk)  # (comp*B, n)

        # ---- per decomp modulus: engine MAC + fused tail ----
        out = torch.empty_like(res)
        for j in range(L):
            acc = self._engine_acc(j, stack, t, keys, kp, True)
            out[:, :, j, :] = self._tail_j(j, e, acc, res, msf)
        return out

    # -- numpy wrappers ------------------------------------------------------

    def prepare_keys(self, k_switch_keys) -> np.ndarray:
        """(L, comp, K, n) u64 from the API's list of flat key arrays."""
        return np.stack([
            np.asarray(kv, dtype=np.uint64).reshape(self.comp, self.K, self.n)
            for kv in k_switch_keys
        ])

    def key_precons(self, keys: np.ndarray) -> np.ndarray:
        """floor(key << 64 / q_j) per element — the Harvey precon tables for
        the MAC (one-time host precompute per key set)."""
        prec = np.zeros_like(keys)
        for j in range(self.K):
            prec[:, :, j, :] = w.precon64_np(keys[:, :, j, :], self.moduli[j])
        return prec

    # key + precon tensors are large (~22 MB at 16384_6_7_7_2): bound the
    # device memory they hold while keeping a handful of Galois keys resident
    KEY_CACHE_SLOTS = 8

    def device_keys(self, k_switch_keys):
        """Upload-once (keys, precons) int64 tensors on self.device, through
        utils/keycache.PinnedKeyCache (LRU, source-array pinning, identity +
        content-checksum guarded)."""
        from ..utils.keycache import PinnedKeyCache

        def _stage(src):
            keys = self.prepare_keys(src)
            return (w.from_u64_np(keys, self.device),
                    w.from_u64_np(self.key_precons(keys), self.device))

        if not hasattr(self, "_key_cache"):
            self._key_cache = PinnedKeyCache(self.KEY_CACHE_SLOTS, _stage)
        return self._key_cache.get(k_switch_keys)

    def prepare_msf4(self, modswitch_factors) -> np.ndarray:
        """(K, 2) u64 [msf, precon] rows: the reduced modswitch factor and its
        Harvey precon floor(msf << 64 / q) — the tail kernel's runtime
        scalars (the reference's (K, 4) u32 `msf4`, one word per value)."""
        out = np.zeros((self.K, 2), dtype=np.uint64)
        for j, (m, q) in enumerate(zip(modswitch_factors, self.moduli)):
            m = int(m) % q
            out[j] = (m, (m << 64) // q)
        return out

    @staticmethod
    def wire_pack_enabled() -> bool:
        return os.environ.get("HEXL_TPU_WIRE_PACK") == "1"

    def dispatch_batch(self, results, t_targets, k_switch_keys,
                       modswitch_factors) -> torch.Tensor:
        """Stage + launch without waiting for the device; returns the
        (B, comp, L, n) int64 tensor on self.device.  The scheduler copies
        the PREVIOUS batch back to the host while this one computes."""
        if self.wire_pack_enabled():
            raise NotImplementedError(f"HEXL_TPU_WIRE_PACK: {_NOT_PORTED}")
        B = results.shape[0]
        n, L = self.n, self.L
        t = w.from_u64_np(
            np.asarray(t_targets, dtype=np.uint64).reshape(B, L, n), self.device
        )
        r = w.from_u64_np(
            np.asarray(results, dtype=np.uint64).reshape(B, self.comp, L, n),
            self.device,
        )
        keys, kp = self.device_keys(k_switch_keys)
        return self._build(t, keys, kp, r, self.prepare_msf4(modswitch_factors))

    def run_batch(self, results, t_targets, k_switch_keys, modswitch_factors):
        B = results.shape[0]
        out = self.dispatch_batch(results, t_targets, k_switch_keys,
                                  modswitch_factors)
        return w.to_u64_np(out).reshape(B, -1)

    def run(self, result, t_target, k_switch_keys, modswitch_factors):
        return self.run_batch(
            np.asarray(result, dtype=np.uint64)[None],
            np.asarray(t_target, dtype=np.uint64)[None],
            k_switch_keys,
            modswitch_factors,
        )[0]


@functools.lru_cache(maxsize=16)
def _context_cached(n, L, K, rns, comp, moduli, tw_key, device,
                    plain_modulus, mac_impl):
    # strict lookup: a stash entry evicted between insertion and this call
    # must raise, not silently build the context with default twiddles
    tw = _TWIDDLE_STASH[tw_key] if tw_key is not None else None
    return KeySwitchContext(
        n, L, K, rns, comp, list(moduli), tw, device,
        plain_modulus=plain_modulus, mac_impl=mac_impl,
    )


# Side table carrying the (unhashable) twiddle buffer into the lru-cached
# context factory, keyed by a strong content digest; bounded to the context
# LRU's size so stash entries die with the contexts built from them.
_TWIDDLE_STASH: "dict[bytes, np.ndarray]" = {}
_TWIDDLE_STASH_SLOTS = 16


def get_context(
    n, decomp_modulus_size, key_modulus_size, rns_modulus_size,
    key_component_count, moduli, twiddle_factors=None, device="cuda",
    plain_modulus: int | None = None, mac_impl: str = "deferred",
) -> KeySwitchContext:
    if twiddle_factors is not None:
        import hashlib

        tw = np.ascontiguousarray(np.asarray(twiddle_factors, dtype=np.uint64))
        tw_key = hashlib.blake2b(tw.tobytes(), digest_size=16).digest()
        _TWIDDLE_STASH.pop(tw_key, None)
        _TWIDDLE_STASH[tw_key] = tw  # re-insert: newest at dict tail
        while len(_TWIDDLE_STASH) > _TWIDDLE_STASH_SLOTS:
            _TWIDDLE_STASH.pop(next(iter(_TWIDDLE_STASH)))
    else:
        tw_key = None
    return _context_cached(
        n, decomp_modulus_size, key_modulus_size, rns_modulus_size,
        key_component_count, tuple(int(m) for m in moduli), tw_key,
        str(torch.device(device)),
        None if plain_modulus is None else int(plain_modulus),
        mac_impl,
    )
