"""Multi-device parallelism on an SPMD `Mesh` of torch.distributed groups.

The counterpart of `hexl_fpga_tpu/parallel/sharded.py`, over the same three
axes:

* 'dp', batch sharding: `batch_sharded_fwd_ntt` (and its `_mxu` name), one
  `ntt_fwd` launch per rank on its rows of the batch, no collective.
* 'sp', coefficient sharding: `dist_fwd_ntt` / `dist_inv_ntt` (and their
  `_mxu` names), the binary exchange.  Each rank holds a contiguous block of
  n/P coefficients; the log2 P stages whose butterflies pair coefficients of
  two ranks exchange whole blocks with the XOR partner (`ppermute`) and run
  as torch lane math; the stages inside a block are ONE kernel launch per
  rank (`ntt_fwd` forward, `ntt_inv` inverse) under the rank's own caller
  tables, the twiddles its block's stages read from the global table.
* 'mp', RNS-limb sharding of KeySwitch: `ShardedKeySwitch`, engines
  0..L-1 and the special engine padded to a multiple of P, each rank running
  the engine transforms, MACs and fused tails of the slots it owns, the
  special engine's INTT2 output broadcast by one masked `psum` and the owned
  output slices gathered (`all_gather`); optionally the batch over 'dp'.

Every function here is SPMD: each rank calls it with its own `Mesh` and its
own share of the data, as each device runs the reference's `shard_map` body.
A function that returns a callable builds its tables once, on the mesh's
device.  Values are int64 bit patterns of u64 (`word64`), as in the
single-card port; a CUDA tensor takes the kernels, a CPU tensor their plain
versions.  The reference's int8-limb four-step ('mxu') formulation, its
tile padding and its `interpret` flag exist for the TPU and have no
counterpart: the `_mxu` names call the kernel-backed functions.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..ops import galois_cuda, keyswitch_cuda, nt, ntt_cuda, twiddles, word64 as w
from .mesh import Mesh


# ---------------------------------------------------------------------------
# batch-sharded NTT ('dp')
# ---------------------------------------------------------------------------


def batch_sharded_fwd_ntt(mesh: Mesh, axis: str, n: int, q: int):
    """Forward NTT with the batch sharded over `axis`: fn(x) transforms this
    rank's rows x (B/P, n) (any u64, canonical out) by one `ntt_fwd`
    launch; no collective.  `axis` names the sharded axis, as in the
    reference, and nothing is exchanged over it."""
    mesh.axis_size(axis)  # the axis must exist
    tabs = ntt_cuda.modulus_tables(n, q, device=mesh.device)
    return lambda x: ntt_cuda.ntt_fwd(x, tabs)


def batch_sharded_fwd_ntt_mxu(mesh: Mesh, axis: str, n: int, q: int):
    """The reference's TPU-tier name for batch_sharded_fwd_ntt (its tile
    padding has no counterpart)."""
    return batch_sharded_fwd_ntt(mesh, axis, n, q)


# ---------------------------------------------------------------------------
# coefficient-sharded NTT ('sp')
# ---------------------------------------------------------------------------


def _sp_shape(mesh: Mesh, axis: str, n: int):
    """(P, block, rank's index) of an sp transform; a block must be a row
    the kernels take (a power of two, at least 4)."""
    P, p = mesh.axis_size(axis), mesh.axis_index(axis)
    if not (nt.is_power_of_two(P) and P >= 2):
        raise ValueError(f"coefficient sharding needs a power of two >= 2 ranks, got {P}")
    if n % P or n // P < 4:
        raise ValueError(f"n = {n} over {P} ranks: each rank needs a block of "
                         f"at least 4 coefficients")
    return P, n // P, p


def fwd_block_tables(n: int, q: int, P: int, p: int):
    """(twiddles, precons) of rank p's block of n/P coefficients: the
    forward stages inside a block of P blocks, as `ntt_fwd` reads them.
    Stage m' (m' groups in the block) of rank p is the global stage P*m',
    whose group b of the block is global group p*m' + b, twiddle
    fwd[(P + p)*m' + b]; the block's table holds it at m' + b."""
    t = twiddles.ntt_tables(n, q)
    S = n // P
    idx = np.zeros(S, dtype=np.int64)
    m = 1
    while m < S:
        idx[m:2 * m] = (P + p) * m + np.arange(m)
        m <<= 1
    tab, pre = t.fwd[idx], t.fwd_precon[idx]
    tab[0] = pre[0] = 0  # index 0 is never read
    return tab, pre


def inv_block_tables(n: int, q: int, P: int, p: int):
    """(twiddles, precons, last) of rank p's block for `ntt_inv`: the
    inverse stages inside a block (the global stages of m >= P groups).
    `ntt_inv` reads stage m' of a row of S at S - 2m' + 1 + g; here that is
    the global stage of P*m' groups, group p*m' + g, whose twiddle sits at
    n - 2Pm' + 1 + p*m' + g of the global table.  The kernel fuses its last
    stage (m' = 1) with n^-1 and n^-1 * twiddle: given inv_n = 1 and
    inv_n_w = `last` (that stage's twiddle), it runs the plain butterfly, and
    n^-1 is applied after the cross stages."""
    t = twiddles.ntt_tables(n, q)
    S = n // P
    idx = np.zeros(S, dtype=np.int64)
    m = S >> 1
    while m >= 1:
        lo = S - 2 * m + 1
        idx[lo:lo + m] = n - 2 * P * m + 1 + p * m + np.arange(m)
        m >>= 1
    tab, pre = t.inv[idx], t.inv_precon[idx]
    tab[0], pre[0] = 1, nt.barrett_factor(1, 64, q)  # the leading 1
    return tab, pre, int(tab[S - 1])


def dist_fwd_ntt(mesh: Mesh, axis: str, n: int, q: int):
    """Forward NTT with the coefficients sharded over `axis` (P ranks):
    fn(x) takes this rank's block x (B, n/P) of each row (natural order,
    block p holding coefficients p*n/P .. (p+1)*n/P - 1; any u64) and
    returns block p of the bit-reversed, canonical transform, so the
    output lies as the inverse's input does.

    Stage m = 1, 2, .., P/2 pairs block p with block p XOR P/2m: the ranks
    swap whole blocks and the X rank (bit clear) keeps fold(x) +
    lazy(partner * W), the Y rank fold(partner) + 2q - lazy(x * W), W the
    twiddle of the pair's group.  The stages inside a block are one
    `ntt_fwd` under fwd_block_tables."""
    P, S, p = _sp_shape(mesh, axis, n)
    t = twiddles.ntt_tables(n, q)
    cross, m = [], 1
    while m < P:
        dist = P // (2 * m)
        g = m + p // (P // m)
        cross.append((dist, (p & dist) == 0, int(t.fwd[g]), int(t.fwd_precon[g])))
        m <<= 1
    tabs = ntt_cuda.caller_fwd_tables(S, q, *fwd_block_tables(n, q, P, p),
                                      device=mesh.device)
    q_barr = nt.barrett_factor(1, 64, q)

    def fn(x: torch.Tensor) -> torch.Tensor:
        x = w.barrett_canonical(x, q, q_barr)
        for dist, is_x, W, Wp in cross:
            other = mesh.ppermute(x, axis, [(i, i ^ dist) for i in range(P)])
            if is_x:
                x = w.add64(w.cond_sub64(x, 2 * q), w.mul_mod_lazy(other, W, Wp, q))
            else:
                x = w.sub64(w.add64(w.cond_sub64(other, 2 * q), 2 * q),
                            w.mul_mod_lazy(x, W, Wp, q))
        return ntt_cuda.ntt_fwd(x.contiguous(), tabs)

    return fn


def dist_inv_ntt(mesh: Mesh, axis: str, n: int, q: int):
    """Inverse NTT with the coefficients sharded over `axis`: fn(x) takes
    block p (B, n/P) of bit-reversed rows (any u64) and returns block p of
    the natural-order, canonical inverse (n^-1 applied), the placement
    dist_fwd_ntt takes, so INTT -> NTT chains with no reshard.

    The stages inside a block first: one `ntt_inv` under inv_block_tables.
    Then the stages of P/2, .., 1 groups pair block p with p XOR P/2m: the X
    rank keeps fold(x + partner), the Y rank lazy((partner + 2q - x) * W);
    the last (m = 1) folds in n^-1 and n^-1 * W as the reference's fused
    final stage does."""
    P, S, p = _sp_shape(mesh, axis, n)
    t = twiddles.ntt_tables(n, q)
    tab, pre, last = inv_block_tables(n, q, P, p)
    tabs = ntt_cuda.caller_inv_tables(S, q, tab, pre, 1, last, device=mesh.device)
    cross, m = [], P >> 1
    while m >= 1:
        dist = P // (2 * m)
        if m > 1:
            g = n - 2 * m + 1 + p // (P // m)
            wx = None
            wy = (int(t.inv[g]), int(t.inv_precon[g]))
        else:
            wx = (int(t.inv_n), nt.barrett_factor(int(t.inv_n), 64, q))
            wy = (int(t.inv_n_w), nt.barrett_factor(int(t.inv_n_w), 64, q))
        cross.append((dist, (p & dist) == 0, wx, wy))
        m >>= 1

    def fn(x: torch.Tensor) -> torch.Tensor:
        x = ntt_cuda.ntt_inv(x.contiguous(), tabs)
        for dist, is_x, wx, wy in cross:
            other = mesh.ppermute(x, axis, [(i, i ^ dist) for i in range(P)])
            if is_x:
                x = w.cond_sub64(w.add64(x, other), 2 * q)
                if wx is not None:
                    x = w.mul_mod_lazy(x, *wx, q)
            else:
                x = w.mul_mod_lazy(w.sub64(w.add64(other, 2 * q), x), *wy, q)
        return w.cond_sub64(x, q)

    return fn


def _chunked(fn, chunks: int):
    def run(x: torch.Tensor) -> torch.Tensor:
        parts = torch.tensor_split(x, max(1, min(chunks, x.shape[0])))
        return torch.cat([fn(c) for c in parts])

    return run


def dist_fwd_ntt_mxu(mesh: Mesh, axis: str, n: int, q: int, chunks: int = 4):
    """The reference's TPU-tier name: dist_fwd_ntt run on `chunks` slices
    of the batch in turn (the reference's chunks overlap one chunk's
    collective with the next chunk's matmuls; here they only partition the
    batch, and the bits do not depend on them)."""
    return _chunked(dist_fwd_ntt(mesh, axis, n, q), chunks)


def dist_inv_ntt_mxu(mesh: Mesh, axis: str, n: int, q: int, chunks: int = 4):
    """The reference's TPU-tier name for dist_inv_ntt (see dist_fwd_ntt_mxu)."""
    return _chunked(dist_inv_ntt(mesh, axis, n, q), chunks)


# ---------------------------------------------------------------------------
# limb-sharded KeySwitch ('mp', optionally x 'dp')
# ---------------------------------------------------------------------------


class ShardedDecomposition:
    """A rank's share of a hoisted decomposition: (owned engines, L*B, n),
    plane i the NTT under the i-th engine this rank owns of the stacked
    INTT1 outputs of its B batch rows."""

    def __init__(self, data: torch.Tensor, batch: int):
        self.data = data
        self.batch = batch


class ShardedKeySwitch:
    """KeySwitch with the RNS engines sharded over `limb_axis` and the batch
    over `batch_axis` (None: not sharded).

    Engines 0..L-1 (decomp) and the special engine K-1, padded with idle
    slots (-1) to a multiple of P; rank p owns slots p*per_shard ..
    (p+1)*per_shard - 1.  Per batch each rank runs INTT1 of every decomp
    limb (replicated: the reference's broadcast point), then for each owned
    engine its transform of the INTT1 outputs and MAC (`ntt_fwd` and the
    single-card context's glue), the special engine's owner its INTT2, whose
    output e reaches every rank by one masked psum; each rank then runs the
    fused tail (`ntt_fwd_tail`) of its owned decomp engines, and an
    all_gather over `limb_axis` (then `batch_axis`) assembles the output.
    The arithmetic is the single-card `KeySwitchContext`'s, per engine, so
    the bits are its own."""

    def __init__(self, mesh: Mesh, limb_axis: str, batch_axis: str | None,
                 n: int, decomp_modulus_size: int, key_modulus_size: int,
                 moduli: Sequence[int], plain_modulus: int | None = None):
        self.mesh = mesh
        self.limb_axis = limb_axis
        self.batch_axis = batch_axis
        self.n = n
        self.L = decomp_modulus_size
        self.K = key_modulus_size
        self.moduli = tuple(int(m) for m in moduli)
        self.P = mesh.axis_size(limb_axis)
        self.plain_modulus = plain_modulus
        engines = list(range(self.L)) + [self.K - 1]
        while len(engines) % self.P:
            engines.append(-1)  # idle slot
        self.engines = engines
        self.per_shard = len(engines) // self.P
        me = mesh.axis_index(limb_axis)
        self.owned = engines[me * self.per_shard:(me + 1) * self.per_shard]
        self.e_owner = engines.index(self.K - 1) // self.per_shard
        # one single-card context on this rank's device: tables, _fix, the
        # BGV constants and the per-engine pieces of its schedule
        self.ctx = keyswitch_cuda.KeySwitchContext(
            n, self.L, self.K, self.L + 1, 2, self.moduli, None,
            device=mesh.device, plain_modulus=plain_modulus)

    # -- SPMD helpers --------------------------------------------------------

    def _batch_rows(self, B: int) -> slice:
        """This rank's rows of a batch of B."""
        if self.batch_axis is None:
            return slice(0, B)
        D, d = self.mesh.axis_size(self.batch_axis), self.mesh.axis_index(self.batch_axis)
        if B % D:
            raise ValueError(f"batch {B} does not split over {D} ranks of "
                             f"'{self.batch_axis}'")
        return slice(d * (B // D), (d + 1) * (B // D))

    def _stage(self, a, B: int, shape) -> torch.Tensor:
        a = np.asarray(a, dtype=np.uint64).reshape((B,) + shape)
        return w.from_u64_np(a[self._batch_rows(B)], self.mesh.device)

    def _gather(self, out: torch.Tensor, B: int) -> np.ndarray:
        """The rank's (B/D, 2, L, n) rows -> the whole (B, 2*L*n) result."""
        if self.batch_axis is not None:
            out = self.mesh.all_gather(out, self.batch_axis).flatten(0, 1)
        return w.to_u64_np(out).reshape(B, -1)

    def _broadcast_e(self, e_mine, rows: int) -> torch.Tensor:
        """The special engine's output on every rank of the limb axis: a
        psum with one non-zero contributor (its owner), so no sum wraps."""
        mine = self.mesh.axis_index(self.limb_axis) == self.e_owner
        assert (e_mine is not None) == mine, "e comes from its owner alone"
        if e_mine is None:
            e_mine = torch.zeros((rows, self.n), dtype=torch.int64,
                                 device=self.mesh.device)
        return self.mesh.psum(e_mine, self.limb_axis)

    def _apply(self, engine_acc, res, msf, index=None) -> torch.Tensor:
        """The rank's schedule from its engines' lazy sums on (the sharded
        `KeySwitchContext._finish`): engine_acc(j, skip_t_term) -> (2, B,
        n); res (B, 2, L, n).  index: the deferred Galois permutation of
        the rank's own output planes.  Returns (B, 2, L, n) on every rank of
        the limb axis."""
        ctx, L, n = self.ctx, self.L, self.n
        B = res.shape[0]
        e_mine, accs = None, {}
        for j in self.owned:
            if j == self.K - 1:
                e_mine = ctx._intt2(engine_acc(j, False))
            elif j >= 0:
                accs[j] = engine_acc(j, True)
        e = self._broadcast_e(e_mine, 2 * B)
        sigma = ctx._sigma(e) if self.plain_modulus is not None else None
        slots = res.new_zeros((self.per_shard, B, 2, n))
        for s, j in enumerate(self.owned):
            if j in accs:
                slots[s] = ctx._tail_j(j, e, accs[j], res, msf, sigma)
        if index is not None:
            slots = slots.index_select(-1, index)
        out = self.mesh.all_gather(slots, self.limb_axis).flatten(0, 1)
        # decomp engine j sits at global slot j
        return out[:L].permute(1, 2, 0, 3).contiguous()

    # -- the full path -------------------------------------------------------

    def run(self, results, t_targets, k_switch_keys, modswitch_factors) -> np.ndarray:
        """results (B, 2*L*n), t_targets (B, L*n) host u64, the WHOLE
        batch on every rank -> the whole (B, 2*L*n) output on every rank."""
        B = np.asarray(results).shape[0]
        L, n = self.L, self.n
        t = self._stage(t_targets, B, (L, n))
        res = self._stage(results, B, (2, L, n))
        keys, kp = self._staged_keys(k_switch_keys)
        msf = self.prepare_msf4(modswitch_factors)
        stack = self.ctx._intt1(t)  # replicated on every rank
        out = self._apply(
            lambda j, skip: self.ctx._engine_acc(j, stack, t, keys, kp, skip),
            res, msf)
        return self._gather(out, B)

    # -- hoisting ------------------------------------------------------------

    def hoist(self, t_targets) -> ShardedDecomposition:
        """Decompose (B, L*n) targets once: INTT1 (replicated), then the
        transform of the stacked rows under each engine this rank owns
        (the single-card `_decompose`'s planes, each where its MAC runs)."""
        B = np.asarray(t_targets).shape[0]
        t = self._stage(t_targets, B, (self.L, self.n))
        stack = self.ctx._intt1(t)
        planes = [ntt_cuda.ntt_fwd(stack, self.ctx._tabs[j])
                  for j in self.owned if j >= 0]
        data = (torch.stack(planes) if planes else
                stack.new_zeros((0,) + tuple(stack.shape)))
        return ShardedDecomposition(data, t.shape[0])

    def run_hoisted(self, dec: ShardedDecomposition, results, k_switch_keys,
                    modswitch_factors, galois: int | None = None) -> np.ndarray:
        """A KeySwitch from a hoisted decomposition into results (the whole
        (B, 2*L*n) batch on every rank).  galois (odd, mod 2n): the keys
        staged pre-permuted by sigma^-1, each rank permuting its own output
        planes (the single-card run_hoisted's deferred automorphism);
        equal to the single-card run_hoisted bit for bit."""
        B = np.asarray(results).shape[0]
        L, n = self.L, self.n
        res = self._stage(results, B, (2, L, n))
        if dec.batch != res.shape[0]:
            raise ValueError(f"decomposition batch {dec.batch} != {res.shape[0]} rows")
        sigma = index = None
        if galois is not None:
            sigma = galois_cuda.ntt_galois_sigma(n, int(galois))
            index = galois_cuda.galois_index(n, int(galois), self.mesh.device)
        keys, kp = self._staged_keys(k_switch_keys, hoist_perm=sigma)
        plane = {j: i for i, j in enumerate(j for j in self.owned if j >= 0)}
        out = self._apply(
            lambda j, _skip: self.ctx._mac(dec.data[plane[j]].view(L, -1, n),
                                           j, keys, kp),
            res, self.prepare_msf4(modswitch_factors), index)
        return self._gather(out, B)

    # -- keys, factors, traffic ----------------------------------------------

    def _staged_keys(self, k_switch_keys, hoist_perm=None):
        """(keys, precons) on the rank's device, uploaded once per key set
        (and per sigma for hoist_perm) by the context's PinnedKeyCache."""
        return self.ctx.device_keys(k_switch_keys, hoist_perm=hoist_perm)

    def prepare_msf4(self, modswitch_factors) -> np.ndarray:
        """(K, 2) u64 [msf, precon] rows (the reference's (K, 4) u32 rows,
        one word per value; the single-card context's layout)."""
        return self.ctx.prepare_msf4(modswitch_factors)

    def comm_report(self, batch: int) -> dict:
        """Collective bytes of one run over the limb axis: the e psum and
        the owned-slice gather.  A (batch, 2, n) plane of int64 moves the
        same bytes as the reference's u32 pair."""
        plane = batch * 2 * self.n * 8
        return {
            "e_broadcast_psum_bytes": plane,
            "output_slice_gather_bytes": self.L * plane,
            "full_tensor_psum_bytes": 0,
        }
