"""KeySwitch on the card: hand-written NTT kernels composed with torch glue.

The counterpart of `hexl_fpga_tpu/ops/keyswitch_tpu.py` (`KeySwitchTpuContext`
with its handles, chains and hoisting).  Per batch of B ops at (n, L decomp
moduli, K key moduli, 2 key components) the default schedule is

  INTT1            one ntt_inv per decomp modulus over (B, n)         L launches
  special engine   ntt_fwd of the stacked INTT1 outputs (L*B, n) under
                   q_k, keyswitch_mac against the keys, Barrett, ntt_inv
                   over (2B, n), +q_k/2                          1 + 1 + 1 launches
  decomp engines   ntt_fwd of the same stack under q_j, keyswitch_mac   2L launches
  tails            ntt_fwd_tail per decomp modulus over (2B, n)      L launches

and the constructor's options move parts of it:

  fused_mac=True      each engine is ONE ntt_fwd_mac launch (transform and
                      key MAC fused; the identity limb's term is one
                      keyswitch_mac over that limb), L + 1 launches in place
                      of L + 1 ntt_fwd and keyswitch_mac;
  mac_impl="exact128" the MAC as torch glue that accumulates full 128-bit
                      products and reduces once per sum (no precon reads);
  fused_tail=False    the tail as torch glue around ntt_fwd;
  plain_modulus=t     the BGV tail: a per-coefficient digit sigma, computed
                      once from the INTT2 output, folded into every tail.

The stacked INTT1 outputs feed every engine UNREDUCED: ntt_fwd, ntt_fwd_mac
and ntt_fwd_tail reduce ANY u64 on load, so the Barrett passes in front of
each engine fold into the kernels, and the reference's `data_bits` widening
(53, or 54 under a plain modulus) has no counterpart.  The special engine's
Barrett, the +q_k/2 and sigma are plain torch ops on int64 bit patterns, as
they are XLA-composed in the reference; the deferred key MAC, XLA-composed
there too, is the hand-written keyswitch_mac kernel here.

Values live on the device as one int64 bit pattern per u64; there are no
(lo, hi) planes, no row padding to a tile and no interleaved staging entry —
those exist in the reference for its target's sake.  A device handle
(`DeviceTarget`, `DeviceCiphertext`, `DeviceDecomposition`) holds one such
tensor on the context's device.
"""

from __future__ import annotations

import functools
import hashlib
import os
import threading
from collections import OrderedDict
from math import gcd
from typing import Optional, Sequence

import numpy as np
import torch

from . import galois_cuda, nt, ntt_cuda, twiddles, wirepack, word64 as w
from ..utils.graph import GraphProgram, GraphQueue

# dispatch_batch's bodies on its unpacked route, by how they ran: captured
# into a CUDA graph (each also replayed), replayed, or launched one by one
# (a key's first dispatch, and every one off the card); counted across the
# process, as keycache.UPLOADS counts key uploads
GRAPHS = {"captures": 0, "replays": 0, "eager": 0}
_graphs_count_lock = threading.Lock()


def _count(kind: str) -> None:
    with _graphs_count_lock:
        GRAPHS[kind] += 1


class _BodyEntry:
    """dispatch_batch's record of one (B, key set, msf): the key and precon
    tensors, its dispatches, its program once captured, whether a thread is
    capturing it, and whether the program has replayed since its capture."""

    __slots__ = ("keys", "kp", "uses", "program", "capturing", "replayed")

    def __init__(self, keys, kp):
        self.keys, self.kp = keys, kp
        self.uses, self.program, self.capturing, self.replayed = 0, None, False, False


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
        if fused_mac and mac_impl == "exact128":
            # the fused engine closes its own Harvey sums; the reference leaves
            # the combination undefined (its fused route hands a 2-tuple to a
            # 4-limb accumulator)
            raise ValueError(
                "fused_mac=True and mac_impl='exact128' do not combine: the "
                "fused engine kernel has its own MAC schedule"
            )
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
        self.fused_mac = fused_mac
        self.fused_tail = fused_tail
        self.mac_impl = mac_impl
        # the key caches are shared by every worker thread that runs this
        # context (NUM_DEV > 1, or the C++ runtime's workers): one stages a
        # key set while the others wait for it
        self._keys_lock = threading.Lock()
        # dispatch_batch's graphs of the body (_dispatch_body), by batch size,
        # staged key set and modswitch factors; None runs every body eager
        self._graph_program = GraphProgram if self.device.type == "cuda" else None
        self._graphs: OrderedDict = OrderedDict()
        self._graphs_lock = threading.Lock()
        self._graph_queue = GraphQueue(self.device)
        self._need = 2  # the dispatch of a key that captures (_dispatch_body)
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
        # BGV mode (plain_modulus = t): the tail subtracts d' = [d]_qk + qk*u'
        # with u' = [-[d]_qk * qk^{-1}]_t centered — divisible by t, so the
        # switched ciphertext stays exact mod t (golden.keyswitch docstring).
        # Implemented as a per-coefficient digit sigma = u' + t/2 in [0, t)
        # computed once from the INTT2 output, then folded into each decomp
        # tail as e += sigma * (qk mod q_j) with a BGV fix constant.
        self.plain_modulus = None if plain_modulus is None else int(plain_modulus)
        if self.plain_modulus is not None:
            t = self.plain_modulus
            assert t >= 2, "plain_modulus must be >= 2"
            assert gcd(self.qk, t) == 1, (
                "special modulus must be coprime to plain_modulus"
            )
            assert t < min(self.moduli), (
                "plain_modulus must be below every coefficient modulus"
            )
            self.t_half = t >> 1
            self.inv_qk_t = nt.inverse_mod(self.qk % t, t)
            self.qk_half_t = self.qk_half % t
            self.t_barr = nt.barrett_factor(1, 64, t)
            self._fix = [
                (-self.qk_half - self.qk * self.t_half) % self.moduli[j]
                for j in range(self.L)
            ]
            self._qk_mod = [self.qk % self.moduli[j] for j in range(self.L)]
        else:
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
    def _mac_sum128(val, key):
        """QUOTIENT-FREE MAC (mac_impl="exact128"): the full 128-bit products
        key*val summed over the source limbs (dim 0) as a (low, high) pair of
        64-bit halves; no Harvey quotient per term and the precon tables are
        never read.  Exact: key < q < 2^52 and val any u64, so each product is
        below 2^116 and a sum of at most 7 fits 128 bits."""
        lo, hi = w.mul64_full(key, val)
        acc = (lo[0], hi[0])
        for i in range(1, lo.shape[0]):
            acc = w.add128(acc, (lo[i], hi[i]))
        return acc

    @staticmethod
    def _mac_close128(acc, q):
        """128-bit sum (< 2^119) -> a lazy u64 representative below 4q.

        V = A + 2^64 * B with A the low half (any u64) and B the high half
        (< 2^55).  B reduces exactly (Barrett); A folds to a representative
        below 3q with one floor(2^64/q) quotient (short by less than 2 for
        ANY u64 A, each unit costing +q)."""
        q = int(q)
        barr = (1 << 64) // q
        A, B = acc
        b = w.barrett_reduce64(B, q, barr)
        t = w.mul_mod_static(b, (1 << 64) % q, q)
        rep_a = w.sub64(A, w.mullo64(w.mulhi64(A, barr), q))
        return w.add64(rep_a, t)

    def _mac(self, val, j, keys, kp, rows=slice(None)):
        """Lazy MAC sums (comp, B, n) under engine modulus j of the source
        limbs `rows`: val (len(rows), B, n) against key column j, by the
        context's MAC schedule."""
        return self._mac_col(val, j, keys[rows, :, j, None, :],
                             kp[rows, :, j, None, :])

    def _mac_col(self, val, j, key, kp):
        """_mac on a key column already taken: val (L', 1 or B, n), key, kp
        (L', comp, 1 or B, n), one key row for every batch row or one for
        each.  The deferred MAC is one keyswitch_mac call: lazy sums of
        [0, 4q) terms, < 28q < 2^58 for q <= 2^52 and L' <= 7."""
        q = self.moduli[j]
        if self.mac_impl == "exact128":
            return self._mac_close128(self._mac_sum128(val[:, None], key), q)
        return ntt_cuda.keyswitch_mac(val, key, kp, q)

    def _engine_acc(self, j, stack, t, keys, kp, skip_t_term):
        """Lazy MAC sums (comp, B, n), < 28q, for engine modulus j."""
        L, n = self.L, self.n
        B = t.shape[0]
        if self.fused_mac:
            # one kernel: transform + MAC; the identity limb i == j (INTT_q
            # then NTT_q is the identity on canonical inputs) stays out of it
            # and its term comes from t_target, by the glue.  At L == 1 that
            # term is the decomp engine's only one: no kernel runs.
            acc = None
            if not (skip_t_term and L == 1):
                acc = ntt_cuda.ntt_fwd_mac(stack, keys, kp, j, self._tabs[j],
                                           j if skip_t_term else None)
            if skip_t_term:
                ident = self._mac(t[:, j, :][None], j, keys, kp, slice(j, j + 1))
                acc = ident if acc is None else w.add64(acc, ident)
            return acc
        val = ntt_cuda.ntt_fwd(stack, self._tabs[j]).view(L, B, n)
        if skip_t_term:
            # identity limb: its MAC term comes from t_target directly
            # (val is this engine's own buffer: updated in place)
            val[j] = t[:, j, :]
        return self._mac(val, j, keys, kp)

    def _sigma(self, e):
        """BGV correction digit per coefficient: sigma = [(qk/2 - e) *
        qk^{-1} + t/2]_t, computed ONCE from the INTT2 output e (canonical
        under q_k).  sigma - t/2 is the centered multiple of qk that makes
        the subtracted tail value divisible by t (see __init__)."""
        t = self.plain_modulus
        e_t = w.barrett_reduce64(e, t, self.t_barr)
        x = w.cond_sub64(w.add64(w.sub64(self.qk_half_t, e_t), t), t)
        u = w.mul_mod_static(x, self.inv_qk_t, t)
        return w.add_mod(u, self.t_half, t)

    def _tail_j(self, j, e, acc, res, msf, sigma=None):
        """Per-decomp-modulus tail: e (comp*B, n) canonical under q_k, lazy
        MAC sums acc (comp, B, n), caller rows res (B, comp, L, n) ->
        (B, comp, n) output rows.  sigma (BGV contexts only) folds the mod-t
        correction into e before the transform: e + sigma * (qk mod q_j)
        < qk + q_j, which the transforms reduce on load like any u64.
        Fused-tail contexts run one kernel; otherwise the torch composition
        around ntt_fwd."""
        comp, n = self.comp, self.n
        B = res.shape[0]
        q = self.moduli[j]
        if sigma is not None:
            e = w.add64(e, w.mul_mod_static(sigma, self._qk_mod[j], q))
        res_j = res[:, :, j, :].transpose(0, 1).reshape(comp * B, n).contiguous()
        acc = acc.view(comp * B, n)
        if self.fused_tail:
            out = ntt_cuda.ntt_fwd_tail(
                e, acc, res_j, self._tabs[j], self._fix[j],
                int(msf[j, 0]), int(msf[j, 1]),
            )
        else:
            acc = w.barrett_reduce64(acc, q, self.q_barr[j])
            # f = e + fix, unreduced; the transform's output is canonical
            g = ntt_cuda.ntt_fwd(w.add64(e, self._fix[j]), self._tabs[j])
            t1 = w.reduce_mod_factor(
                w.add64(w.sub64(acc, g), 4 * q), q, 8
            )
            delta = w.mul_mod_static(t1, int(msf[j, 0]), q)
            out = w.cond_sub64(w.add64(res_j, delta), q)
        return out.view(comp, B, n).transpose(0, 1)

    def _intt2(self, acc_sp):
        """The special engine's lazy sums (comp, B, n) -> e (comp*B, n),
        canonical under q_k: Barrett, INTT2 over both components in one
        call, + q_k/2."""
        sp = self.K - 1
        acc_sp = w.barrett_reduce64(acc_sp, self.qk, self.q_barr[sp])
        d = ntt_cuda.ntt_inv(acc_sp.view(-1, self.n), self._tabs[sp])
        return w.add_mod(d, self.qk_half, self.qk)

    def _finish(self, engine_acc, res, msf):
        """The schedule from the engines' lazy sums on: special engine first
        (engine K-1 + INTT2), then per decomp modulus its engine and tail.
        engine_acc(j, skip_t_term) -> (comp, B, n); res (B, comp, L, n)."""
        e = self._intt2(engine_acc(self.K - 1, False))
        sigma = self._sigma(e) if self.plain_modulus is not None else None

        # contiguous whatever res's strides (a graph's res is limb-major)
        out = torch.empty(res.shape, dtype=res.dtype, device=res.device)
        for j in range(self.L):
            out[:, :, j, :] = self._tail_j(j, e, engine_acc(j, True), res, msf,
                                           sigma)
        return out

    def _intt1(self, t):
        """INTT1 per decomp modulus (batch B each), stacked (L*B, n)."""
        return torch.cat([
            ntt_cuda.ntt_inv(t[:, i, :].contiguous(), self._tabs[i])
            for i in range(self.L)
        ])

    def _build(self, t, keys, kp, res, msf):
        """t: (B, L, n); keys + key precons: (L, comp, K, n);
        res: (B, comp, L, n) — int64 bit patterns on self.device.
        msf: (K, 2) u64 HOST array of [reduced modswitch factor, its Harvey
        precon] rows — they become kernel scalar arguments.
        Returns (B, comp, L, n)."""
        stack = self._intt1(t)
        return self._finish(
            lambda j, skip: self._engine_acc(j, stack, t, keys, kp, skip),
            res, msf,
        )

    # -- numpy wrappers ------------------------------------------------------

    def prepare_keys(self, k_switch_keys) -> np.ndarray:
        """(L, comp, K, n) u64 from the API's list of flat key arrays.  A
        longer list (a scheme's keys for every decomp modulus, switched at a
        lower level) contributes its first L, as in golden.keyswitch."""
        if len(k_switch_keys) < self.L:
            raise ValueError(
                f"{len(k_switch_keys)} key arrays for {self.L} decomp moduli")
        return np.stack([
            np.asarray(kv, dtype=np.uint64).reshape(self.comp, self.K, self.n)
            for kv in k_switch_keys[:self.L]
        ])

    def key_precons(self, keys: np.ndarray) -> np.ndarray:
        """floor(key << 64 / q_j) per element — the Harvey precon tables for
        the MAC (one-time host precompute per key set)."""
        prec = np.zeros_like(keys)
        for j in range(self.K):
            prec[:, :, j, :] = w.precon64_np(keys[:, :, j, :], self.moduli[j])
        return prec

    # key + precon tensors are large (2 * L * comp * K * n * 8 bytes a set):
    # bound the device memory they hold while keeping a handful of Galois keys
    # resident
    KEY_CACHE_SLOTS = 8

    # permuted-key caches held per Galois sigma (hoisted rotations): each
    # distinct permutation gets its own small PinnedKeyCache (a rotation step
    # pairs ONE sigma with ONE Galois key set, so 2 slots suffice); the dict
    # itself is LRU-bounded to cap device memory.
    PERM_CACHE_SLOTS = 32

    def device_keys(self, k_switch_keys, hoist_perm=None):
        """Upload-once (keys, precons) int64 tensors on self.device, through
        utils/keycache.PinnedKeyCache (LRU, source-array pinning, identity +
        content-checksum guarded).

        hoist_perm (an (n,) NTT-domain Galois sigma, concrete numpy) stages
        the keys PRE-PERMUTED by sigma^{-1}: the automorphism commutes with
        the elementwise MAC, P(D_i) * k_i == P(D_i * P^{-1} k_i), so a hoisted
        apply runs its MAC and tail on the UNPERMUTED decomposition against
        these keys and permutes only the output (see _apply_hoisted).  The
        permutation runs once per (sigma, key set) at stage time."""
        from ..utils.keycache import PinnedKeyCache

        def _stage(src, inv=None):
            keys = self.prepare_keys(src)
            if inv is not None:
                keys = np.ascontiguousarray(keys[..., inv])
            return (w.from_u64_np(keys, self.device),
                    w.from_u64_np(self.key_precons(keys), self.device))

        with self._keys_lock:
            if hoist_perm is None:
                if not hasattr(self, "_key_cache"):
                    self._key_cache = PinnedKeyCache(self.KEY_CACHE_SLOTS, _stage)
                return self._key_cache.get(k_switch_keys)
            p = np.asarray(hoist_perm, dtype=np.int64).reshape(self.n)
            pid = hashlib.blake2b(p.tobytes(), digest_size=16).digest()
            if not hasattr(self, "_key_cache_perm"):
                self._key_cache_perm = OrderedDict()
            cache = self._key_cache_perm.get(pid)
            if cache is None:
                inv = np.empty_like(p)
                inv[p] = np.arange(self.n, dtype=np.int64)
                cache = PinnedKeyCache(2, functools.partial(_stage, inv=inv))
                self._key_cache_perm[pid] = cache
                while len(self._key_cache_perm) > self.PERM_CACHE_SLOTS:
                    self._key_cache_perm.popitem(last=False)
            else:
                self._key_cache_perm.move_to_end(pid)
            return cache.get(k_switch_keys)

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
        (B, comp, L, n) int64 tensor on self.device.  results / t_targets
        are host arrays or handles already staged (the executor uploads on
        its copy stream).  The scheduler copies the PREVIOUS batch back to
        the host while this one computes.

        Under HEXL_TPU_WIRE_PACK=1 the operands must be host arrays: they
        cross packed (pack_operands, dispatch_batch_packed) and the result
        is the (B, comp, L, 13n/8) int32 tensor of packed words."""
        if self.wire_pack_enabled():
            if isinstance(results, _Handle) or isinstance(t_targets, _Handle):
                raise TypeError("HEXL_TPU_WIRE_PACK=1 packs host operands; "
                                "a device handle is already on the card")
            rp, tp = self.pack_operands(results, t_targets)
            return self.dispatch_batch_packed(
                wirepack.to_device(rp, self.device),
                wirepack.to_device(tp, self.device),
                k_switch_keys, modswitch_factors)
        r, t = self._handles(results, t_targets)
        keys, kp = self.device_keys(k_switch_keys)
        return self._dispatch_body(t.data, keys, kp, r.data,
                                   self.prepare_msf4(modswitch_factors))

    def _dispatch_body(self, t, keys, kp, res, msf):
        """_build for dispatch_batch: on the card a key's first dispatches
        run eager, its `_need`-th captures the body into a GraphProgram and
        later ones replay it.  A key is (B, the staged key set by identity,
        msf, whose rows the capture bakes in as kernel scalars); its entry
        holds its key tensors, so no identity is reused while it lives and a
        graph never reads a set the key cache has freed.  At most
        KEY_CACHE_SLOTS entries, the least recently used leaving first; the
        graphs share their context's GraphQueue.  The capture runs outside
        the cache's lock: meanwhile the key's other dispatches run eager.

        `_need` is the reuse the context has measured: 2 at first (a key's
        second dispatch captures), one more each time a graph leaves the
        cache without having replayed after its capture, one less (down to
        2) each time a graph replays for the first time.  So traffic whose
        keys come back only after others have pushed them out (batch sizes
        that change every call, more key sets than the cache holds) stops
        paying for captures it never reuses, and a key that then repeats
        still gets its graph.

        The static inputs hold the operands limb-major, (L, B, n) and
        (L, comp, B, n): _build's per-limb slices of them are contiguous, so
        the copy-in takes the place of its per-limb copies."""
        limb_major = (t.transpose(0, 1), res.permute(2, 1, 0, 3))
        program = capture = None
        if self._graph_program is not None:
            key = (t.shape[0], id(keys), id(kp), msf.tobytes())
            with self._graphs_lock:
                entry = self._graphs.get(key)
                if entry is None:
                    entry = self._graphs[key] = _BodyEntry(keys, kp)
                self._graphs.move_to_end(key)
                entry.uses += 1
                if entry.program is not None:
                    program = entry.program
                    if not entry.replayed:
                        entry.replayed = True
                        self._need = max(2, self._need - 1)
                elif not entry.capturing and entry.uses >= self._need:
                    entry.capturing, capture = True, entry
                while len(self._graphs) > self.KEY_CACHE_SLOTS:
                    _, old = self._graphs.popitem(last=False)
                    if (old.program is not None or old.capturing) and not old.replayed:
                        self._need += 1
        if capture is not None:
            def run(tl, rl):
                return self._build(tl.transpose(0, 1), keys, kp,
                                   rl.permute(2, 1, 0, 3), msf)

            program = self._graph_program(run, *limb_major, queue=self._graph_queue,
                                          warm=False, holds=(keys, kp))
            with self._graphs_lock:
                capture.program, capture.capturing = program, False
            _count("captures")
        if program is None:
            _count("eager")
            return self._build(t, keys, kp, res, msf)
        _count("replays")
        return program(*limb_major)

    # -- 52-bit wire-packed transport (HEXL_TPU_WIRE_PACK=1) -----------------

    def pack_operands(self, results, t_targets):
        """Host side: (B, comp*L*n) results and (B, L*n) targets -> packed u32
        words (B, comp, L, 13n/8) and (B, L, 13n/8) (ops/wirepack.py's
        native codec)."""
        B = np.asarray(results).shape[0]
        r = np.asarray(results, dtype=np.uint64).reshape(B, self.comp, self.L, self.n)
        t = np.asarray(t_targets, dtype=np.uint64).reshape(B, self.L, self.n)
        return wirepack.pack_u64_native(r), wirepack.pack_u64_native(t)

    def dispatch_batch_packed(self, rp, tp, k_switch_keys, modswitch_factors):
        """Device side of the packed route: the int32 packed operands (as
        pack_operands lays them out, on self.device) are unpacked by torch
        ops, the body runs, and the result is packed again for the copy back
        (the reference's `_build32p`)."""
        keys, kp = self.device_keys(k_switch_keys)
        out = self._build(wirepack.unpack(tp), keys, kp, wirepack.unpack(rp),
                          self.prepare_msf4(modswitch_factors))
        return wirepack.pack(out)

    def run_batch(self, results, t_targets, k_switch_keys, modswitch_factors):
        B = results.shape[0]
        out = self.dispatch_batch(results, t_targets, k_switch_keys,
                                  modswitch_factors)
        if out.dtype == torch.int32:  # packed words
            return wirepack.unpack_u64_native(
                out.cpu().numpy().view(np.uint32)).reshape(B, -1)
        return w.to_u64_np(out).reshape(B, -1)

    def run(self, result, t_target, k_switch_keys, modswitch_factors):
        return self.run_batch(
            np.asarray(result, dtype=np.uint64)[None],
            np.asarray(t_target, dtype=np.uint64)[None],
            k_switch_keys,
            modswitch_factors,
        )[0]

    # -- device-resident ciphertext handles ---------------------------------
    #
    # Chained HE workloads (rotate -> keyswitch -> accumulate ...) pay full
    # host<->device staging per op through the numpy API.  A handle keeps the
    # operand resident: run_device consumes and returns handles, so a chain
    # of keyswitches moves host data 0 times in between.

    def stage_target(self, t_targets) -> "DeviceTarget":
        """Upload (B, L*n) u64 targets once; reusable across run_device calls."""
        t = np.asarray(t_targets, dtype=np.uint64)
        return DeviceTarget(
            w.from_u64_np(t.reshape(t.shape[0], self.L, self.n), self.device),
            self,
        )

    def stage_ciphertext(self, cts) -> "DeviceCiphertext":
        """Upload (B, comp*L*n) u64 ciphertexts once as a device handle."""
        c = np.asarray(cts, dtype=np.uint64)
        return DeviceCiphertext(
            w.from_u64_np(c.reshape(c.shape[0], self.comp, self.L, self.n),
                          self.device),
            self,
        )

    def _handles(self, ct, target):
        if not isinstance(ct, DeviceCiphertext):
            ct = self.stage_ciphertext(ct)
        if target is not None and not isinstance(target, DeviceTarget):
            target = self.stage_target(target)
        assert ct.ctx is self and (target is None or target.ctx is self)
        return ct, target

    def run_device(self, ct, target, k_switch_keys, modswitch_factors
                   ) -> "DeviceCiphertext":
        """KeySwitch entirely on device: ct/target may be handles (stay
        resident) or host u64 arrays (staged here).  Returns a handle; call
        .to_host() only when the chain ends."""
        return self.run_device_chain(ct, target, k_switch_keys,
                                     modswitch_factors, depth=1)

    def run_device_chain(self, ct, target, k_switch_keys, modswitch_factors,
                         depth: int) -> "DeviceCiphertext":
        """depth keyswitches with FIXED keys/target: each step's output
        ciphertext is the next step's accumulator.  The reference compiles
        the loop into one device program; here it is `depth` calls of the
        device body on device tensors, queued on the stream with no host copy
        and no synchronisation between links."""
        return self.run_device_chain_keyed(
            ct, target, [k_switch_keys], modswitch_factors, [0] * int(depth))

    def run_device_chain_keyed(self, ct, target, key_sets, modswitch_factors,
                               schedule) -> "DeviceCiphertext":
        """len(schedule) keyswitches with PER-STEP keys — the rotation-chain
        pattern.  key_sets is a list of S key sets (each the usual sequence of
        L (comp*K*n,) u64 arrays; all stay resident via the pinned key cache),
        schedule an int sequence where step i uses key_sets[schedule[i]]."""
        ct, target = self._handles(ct, target)
        sched = np.asarray(schedule, dtype=np.int32).reshape(-1)
        assert sched.size > 0 and sched.min() >= 0
        assert sched.max() < len(key_sets), "schedule indexes past key_sets"
        staged = [self.device_keys(ks) for ks in key_sets]
        msf = self.prepare_msf4(modswitch_factors)
        cur = ct.data
        for s in sched:
            cur = self._build(target.data, *staged[s], cur, msf)
        return DeviceCiphertext(cur, self)

    # -- hoisted keyswitch (decompose once, apply many) ---------------------
    #
    # Halevi-Shoup hoisting: the PREFIX of the keyswitch — INTT1 of every
    # decomp limb plus the forward NTT into every engine modulus, L + (L+1)*L
    # of the L + (L+1)*L + comp*(L+1) transform rows per op — depends only on
    # the target, not on the key or the Galois automorphism.  Computing it
    # once and reusing it across many applies turns each further rotation of
    # the same ciphertext into {the MAC + INTT2 + the tails + one gather}.

    def _decompose(self, t):
        """(B, L, n) canonical NTT-domain targets -> the hoisted decomposition
        (L+1, L*B, n) over the ACTIVE engines only: plane j < L is decomp
        modulus q_j, plane L the special modulus q_{K-1} (the moduli L..K-2
        between them are never read by the apply):
        D[p, i*B+b] = NTT_{q(p)}(INTT1_{q_i}(t[b, i])), canonical under q(p)
        (the reference's planes hold lazy representatives of the same
        residues)."""
        stack = self._intt1(t)
        return torch.stack([
            ntt_cuda.ntt_fwd(stack, self._tabs[j])
            for j in (*range(self.L), self.K - 1)
        ])

    def _apply_hoisted(self, dec, res, keys, kp, msf, index=None):
        """Keyswitch from a hoisted decomposition dec (see _decompose).

        index, an optional (n,) int64 device tensor holding an NTT-domain
        permutation sigma, makes this an apply of the AUTOMORPHED
        decomposition with the permutation DEFERRED to the output.  The keys
        MUST then be pre-permuted by sigma^{-1}
        (device_keys(..., hoist_perm=sigma)): the automorphism commutes with
        every ring-linear stage, so

            P(D_i) * k_i == P(D_i * P^{-1} k_i)
            out == P( tail(MAC(D, P^{-1}K)) + res )

        where res is the UNPERMUTED accumulation base.  One gather runs over
        the comp*L output planes instead of (L+1)*L decomposition planes.
        Equal to automorph-then-decompose up to the standard hoisting rounding
        trade (the automorphism does not commute with the tail's integer lifts
        at sign-wrapped coefficients); the result decrypts identically up to
        noise.  With index=None the output IS bit-identical to _build: every
        MAC input has the same residue and the tails canonicalise."""
        L, n = self.L, self.n
        B = res.shape[0]

        def engine_acc(j, _skip):
            plane = L if j == self.K - 1 else j
            return self._mac(dec[plane].view(L, B, n), j, keys, kp)

        out = self._finish(engine_acc, res, msf)
        return out if index is None else out.index_select(-1, index)

    def _apply_hoisted_many(self, dec, res, keys, kp, msf, index):
        """S hoisted applies of ONE decomposition (batch 1) as one batch of S:
        step s takes its own keys keys[s], kp[s] (S, L, comp, K, n),
        pre-permuted by sigma_s^{-1}, and its own output permutation index[s]
        ((S, n) int64).  res (S, comp, L, n) is each step's unpermuted
        accumulation base.  Every row is the row _apply_hoisted computes for
        that step alone (the MAC is elementwise per row, the transforms and
        tails per row), so the bits equal S separate calls."""
        L, n = self.L, self.n
        S = keys.shape[0]

        def engine_acc(j, _skip):
            plane = L if j == self.K - 1 else j
            col = (keys[:, :, :, j, :].permute(1, 2, 0, 3),   # (L, comp, S, n)
                   kp[:, :, :, j, :].permute(1, 2, 0, 3))
            return self._mac_col(dec[plane].view(L, 1, n), j, *col)

        out = self._finish(engine_acc, res, msf)        # (S, comp, L, n)
        return out.gather(-1, index.view(S, 1, 1, n).expand_as(out))

    def hoisted_key_stack(self, k_switch_keys, perms):
        """Stacked sigma^{-1}-permuted (keys, precons) for a per-step hoisted
        loop: perms is a sequence of S concrete (n,) sigmas; returns two
        tensors shaped (S,) + key shape, step s holding
        device_keys(keys, hoist_perm=perms[s])."""
        sets = [
            self.device_keys(k_switch_keys, hoist_perm=np.asarray(p))
            for p in perms
        ]
        return tuple(torch.stack([s[i] for s in sets]) for i in range(2))

    def hoist(self, target) -> "DeviceDecomposition":
        """Decompose a keyswitch target ONCE for reuse across many
        run_hoisted applies (different keys and/or Galois permutations of
        the same target).  target: DeviceTarget or host (B, L*n) u64."""
        if not isinstance(target, DeviceTarget):
            target = self.stage_target(target)
        assert target.ctx is self
        return DeviceDecomposition(self._decompose(target.data), self)

    def run_hoisted(self, dec, ct, k_switch_keys, modswitch_factors,
                    perm=None, galois=None) -> "DeviceCiphertext":
        """Apply a keyswitch from a hoisted decomposition, accumulating into
        ct (handle or host (B, comp*L*n) u64).

        galois, if given, is the Galois ELEMENT g (odd int mod 2n): the keys
        stage pre-permuted by sigma_g^{-1} (cached per sigma, see
        device_keys), the apply runs gather-free, and the deferred output
        automorphism is one gather by the cached index of
        galois_cuda.galois_index.  perm is the same for an arbitrary CONCRETE
        (n,) NTT-domain permutation.  ct must be the UNPERMUTED accumulation
        base either way; the output is sigma(ct + delta)."""
        ct, _ = self._handles(ct, None)
        assert dec.ctx is self
        assert dec.batch == ct.batch, (
            f"decomposition batch {dec.batch} != ciphertext batch {ct.batch}"
        )
        index = sigma = None
        if galois is not None:
            assert perm is None, "pass either galois or perm, not both"
            sigma = galois_cuda.ntt_galois_sigma(self.n, int(galois))
            index = galois_cuda.galois_index(self.n, int(galois), self.device)
        elif perm is not None:
            sigma = np.asarray(perm, dtype=np.int64).reshape(self.n)
            index = torch.from_numpy(sigma).to(self.device)
        keys, kp = self.device_keys(k_switch_keys, hoist_perm=sigma)
        out = self._apply_hoisted(dec.data, ct.data, keys, kp,
                                  self.prepare_msf4(modswitch_factors), index)
        return DeviceCiphertext(out, self)


class _Handle:
    """One int64 tensor of u64 bit patterns on a context's device."""

    def __init__(self, data: torch.Tensor, ctx: KeySwitchContext):
        self.data = data
        self.ctx = ctx

    def synchronize(self):
        """Wait until the device has produced the tensor (the reference's
        block_until_ready)."""
        if self.data.device.type == "cuda":
            torch.cuda.synchronize(self.data.device)
        return self


class DeviceDecomposition(_Handle):
    """Hoisted keyswitch prefix resident on device: (L+1, L*B, n) canonical
    residues over the ACTIVE engines (planes 0..L-1 = decomp moduli, plane L =
    the special modulus; see _decompose), reusable across many run_hoisted
    calls; (L+1) * L * n * 8 bytes per op."""

    @property
    def batch(self) -> int:
        return self.data.shape[1] // self.ctx.L


class DeviceCiphertext(_Handle):
    """(B, comp, L, n) ciphertext resident on device."""

    @property
    def batch(self) -> int:
        return self.data.shape[0]

    def to_host(self) -> np.ndarray:
        """Fetch as (B, comp*L*n) u64 (the blocking device->host copy)."""
        return w.to_u64_np(self.data).reshape(self.batch, -1)


class DeviceTarget(_Handle):
    """(B, L, n) keyswitch target resident on device."""

    @property
    def batch(self) -> int:
        return self.data.shape[0]


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
