"""Batched negacyclic NTT / INTT / keyswitch-tail / keyswitch-engine on the card.

Five wrappers over the hand-written CUDA kernels of `csrc/ntt_kernels.cu`,
each with its plain PyTorch version and launch counters beside it:

  ntt_fwd       replaces `hexl_fpga_tpu/ops/ntt_mxu_pallas.py` `_fwd_kernel`
                (entries raw_fwd_call / fwd_ntt_fn): natural in -> bit-reversed
                out under one modulus; the input may be ANY u64 (it is reduced
                on load), the output is canonical.
  ntt_inv       replaces `_inv_kernel` (raw_inv_call / inv_ntt_fn):
                bit-reversed in -> natural out, n^-1 applied, canonical out.
  ntt_fwd_tail  replaces the `raw_fwd_tail_call` kernel: `f = e + fix`,
                forward NTT, then per element
                `out = cond_sub(res + ReduceMod8(acc + 4q - g) * msf, q)`.
  ntt_fwd_mac   replaces the `raw_fwd_mac_call` kernel: forward NTT of the
                stacked source limbs (L*B, n) fused with the key MAC into
                (comp, B, n) lazy u64 sums; `skip_i` leaves one limb out.
  keyswitch_mac the default schedule's lazy key MAC on limbs ntt_fwd has
                transformed: (comp, B, n) lazy u64 sums with the approximate
                Harvey quotient, deferred to once a sum.  No TPU kernel has
                it (the reference composes it in XLA); it replaces torch glue.

`ntt_fwd` and `ntt_inv` are also the counterpart of the batched butterfly
kernels of `hexl_fpga_tpu/ops/ntt_pallas.py` (`_fwd_kernel`, `_inv_kernel`:
canonical in, canonical out, all stages on chip), the standalone transform
behind `api._NTT` / `api._INTT`, at every n up to 32768: a row of 32768
values does not fit one block's shared memory, so it takes C = 2 or 4 pieces
(`split_candidates`), as a shorter row may.  Tables come from
`modulus_tables` (built from a 2n-th root) or from `caller_fwd_tables` /
`caller_inv_tables` (a caller's own arrays, used as given).

What bounds them on an H100: by the count, bytes and multiplies are within a
factor of two of each other.  A coefficient moves 16 bytes (32 in the tail)
and runs log2(n)/2 Harvey butterflies of three 64x64 multiplies, about ten
32-bit multiply-adds each; at n = 16384 against 3.35 TB/s and the card's 32-bit
integer rate, those three come out bytes-bound, the transforms by a few percent
only, and `ntt_fwd_mac`, which writes comp*B rows for L*B read and adds comp
lazy multiplies per coefficient, operations-bound (`chip_smoke.py` computes
both sides for each).  All run several times above that bound (times in
`PERF.md`).  The four kernels run the split cores of
`csrc/ntt_kernels.cuh`: a row over `parts` blocks so the grid fills the
132 SMs, several butterfly stages per barrier in registers, the stages that
cross the pieces done while loading (forward: contiguous pieces; inverse:
strided ones).  `row_split` chooses the parts from (rows, n) and the kernel's
own blocks per SM; `ntt_fwd_mac` sums its source limbs in shared memory over
a cluster of blocks (`mac_split`), with no atomics, and stores each output
once.  The plain versions split the row the same way, so the splits' index
arithmetic is tested on the CPU.  Device memory is touched once each way (the
crossing stages re-read the input from L2), and q, floor(2^64/q), fix and the
modswitch factor are runtime arguments, so one build serves every modulus.

A wrapper launches its kernel for a CUDA tensor and runs the plain version
only for a CPU tensor; a CUDA tensor never reaches the plain version through
a wrapper.  The plain versions are staged butterflies on int64 bit patterns
(`word64`) with the same in/out contract, device-agnostic, and are the
kernels' oracle on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from dataclasses import dataclass

import numpy as np
import torch

from . import _build, nt, twiddles, word64 as w

# launches per kernel since the last reset; a wrapper adds one exactly where
# it launches its kernel
LAUNCHES = {"ntt_fwd": 0, "ntt_inv": 0, "ntt_fwd_tail": 0, "ntt_fwd_mac": 0,
            "keyswitch_mac": 0}
_launches_lock = threading.Lock()  # NUM_DEV > 1: several workers launch
_this_thread = threading.local()  # thread_launches' dict, where one is open

KERNEL_SOURCE = "ntt_kernels.cu"
KERNEL_DEPS = ("ntt_kernels.cuh",)


def reset_launch_counts() -> None:
    with _launches_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


@contextlib.contextmanager
def thread_launches():
    """Count the launches of this thread alone, by kernel, into the dict it
    yields (a rank of `parallel.mesh.run_ranks` is a thread); LAUNCHES
    counts them as well."""
    counts = dict.fromkeys(LAUNCHES, 0)
    _this_thread.counts = counts
    try:
        yield counts
    finally:
        _this_thread.counts = None


# ---------------------------------------------------------------------------
# per-modulus tables
# ---------------------------------------------------------------------------


# the largest n of the kernels' callers (`_NTT` / `_INTT`, api.py); a row of
# MAX_N values takes 2 or 4 blocks (split_candidates)
MAX_N = 32768


def _check_n(n: int) -> None:
    if not (nt.is_power_of_two(n) and 4 <= n <= MAX_N):
        raise ValueError(
            f"no NTT kernel serves n = {n}: n must be a power of two in "
            f"[4, {MAX_N}]"
        )


@dataclass(frozen=True, eq=False)
class ModulusTables:
    """Everything one (n, q, psi) transform needs, on one device."""

    n: int
    q: int
    q_barr: int  # floor(2^64 / q)
    tab: torch.Tensor  # (4, n) int64: fwd, fwd_precon, inv, inv_precon
    inv_n: int = 0
    inv_n_precon: int = 0
    inv_n_w: int = 0
    inv_n_w_precon: int = 0
    # a caller's tables hold one direction only; the other rows are zero
    has_fwd: bool = True
    has_inv: bool = True


def _check_n_q(n: int, q: int) -> None:
    _check_n(n)
    if not 2 < q < (1 << 62):
        raise ValueError("the butterflies need 4q < 2^64: q must be below 2^62")


@functools.lru_cache(maxsize=64)
def _modulus_tables(n: int, q: int, psi, device: str) -> ModulusTables:
    _check_n_q(n, q)
    t = twiddles.ntt_tables(n, q, psi)
    tab = np.stack([t.fwd, t.fwd_precon, t.inv, t.inv_precon])
    return ModulusTables(
        n=n, q=q, q_barr=nt.barrett_factor(1, 64, q),
        tab=w.from_u64_np(tab, device),
        inv_n=t.inv_n, inv_n_precon=nt.barrett_factor(t.inv_n, 64, q),
        inv_n_w=t.inv_n_w, inv_n_w_precon=nt.barrett_factor(t.inv_n_w, 64, q),
    )


def modulus_tables(n: int, q: int, psi: int | None = None,
                   device="cuda") -> ModulusTables:
    """Tables for (n, q) on `device` (the card unless the caller asks for the
    CPU); psi (a primitive 2n-th root, e.g. from a caller's twiddle table)
    defaults to the minimal one."""
    return _modulus_tables(int(n), int(q), None if psi is None else int(psi),
                           str(torch.device(device)))


# caller tables: (n, q, digest of the arrays, device) -> ModulusTables, so a
# second batch under the same tables uploads nothing
_caller_tables: dict = {}
_caller_tables_lock = threading.Lock()
_CALLER_TABLES_MAX = 64


def _caller_tables_cached(key, make) -> ModulusTables:
    with _caller_tables_lock:
        tabs = _caller_tables.get(key)
        if tabs is None:
            if len(_caller_tables) >= _CALLER_TABLES_MAX:
                _caller_tables.pop(next(iter(_caller_tables)))
            tabs = _caller_tables[key] = make()
        return tabs


def _table_rows(n: int, *arrays):
    rows = [np.ascontiguousarray(a, dtype=np.uint64).ravel() for a in arrays]
    for r in rows:
        if r.shape[0] != n:
            raise ValueError(f"twiddle table of {r.shape[0]} values, expected {n}")
    return rows


def caller_fwd_tables(n: int, q: int, root_of_unity_powers, precon,
                      device="cuda") -> ModulusTables:
    """Forward-only tables from a caller's own arrays, used as given:
    `root_of_unity_powers` in bit-reversed order and their precons
    floor(w << 64 / q) (the `_NTT` arguments), on `device` (the card unless
    the caller asks for the CPU).  Cached by content."""
    n, q, device = int(n), int(q), str(torch.device(device))
    _check_n_q(n, q)
    fwd, fp = _table_rows(n, root_of_unity_powers, precon)

    def make():
        zero = np.zeros(n, dtype=np.uint64)
        return ModulusTables(
            n=n, q=q, q_barr=nt.barrett_factor(1, 64, q),
            tab=w.from_u64_np(np.stack([fwd, fp, zero, zero]), device),
            has_inv=False,
        )

    key = ("fwd", n, q, hash((fwd.tobytes(), fp.tobytes())), device)
    return _caller_tables_cached(key, make)


def caller_inv_tables(n: int, q: int, inv_root_of_unity_powers, precon,
                      inv_n: int, inv_n_w: int, device="cuda") -> ModulusTables:
    """Inverse-only tables from a caller's own arrays, used as given: the
    scan-order inverse root powers with the leading 1, their precons, n^-1
    and n^-1 times the last twiddle (the `_INTT` arguments), on `device`
    (the card unless the caller asks for the CPU)."""
    n, q, device = int(n), int(q), str(torch.device(device))
    inv_n, inv_n_w = int(inv_n), int(inv_n_w)
    _check_n_q(n, q)
    if not (0 <= inv_n < q and 0 <= inv_n_w < q):
        raise ValueError("inv_n and inv_n_w must be residues below q")
    inv, ip = _table_rows(n, inv_root_of_unity_powers, precon)

    def make():
        zero = np.zeros(n, dtype=np.uint64)
        return ModulusTables(
            n=n, q=q, q_barr=nt.barrett_factor(1, 64, q),
            tab=w.from_u64_np(np.stack([zero, zero, inv, ip]), device),
            inv_n=inv_n, inv_n_precon=nt.barrett_factor(inv_n, 64, q),
            inv_n_w=inv_n_w, inv_n_w_precon=nt.barrett_factor(inv_n_w, 64, q),
            has_fwd=False,
        )

    key = ("inv", n, q, hash((inv.tobytes(), ip.tobytes(), inv_n, inv_n_w)), device)
    return _caller_tables_cached(key, make)


# ---------------------------------------------------------------------------
# launch shape of the split kernels
# ---------------------------------------------------------------------------


# How the split kernels (ntt_fwd, ntt_fwd_tail, ntt_inv, ntt_fwd_mac) spread a
# row over the card: `parts` blocks of n/parts values each, SPLIT_R butterfly
# stages per register pass, at most SPLIT_THREADS threads a block
# (csrc/ntt_kernels.cu).
SPLIT_R = 3
SPLIT_THREADS = 512
SPLIT_KERNELS = ("ntt_fwd", "ntt_fwd_tail", "ntt_inv", "ntt_fwd_mac")
# For a CUDA tensor the card itself says how many split blocks an SM holds
# (hexl_ntt_split_info) and how many SMs it has.  A CPU tensor, whose plain
# version gives the same bits under every split, takes this model of an H100
# SXM: SMs; shared memory (less 1 KB a block), threads and registers per SM;
# the split kernels' registers per thread by parts as an H100 build reported
# them (PERF.md §6; the forward pair's is the larger of the two).
H100_SM_COUNT = 132
_SM_SMEM, _BLOCK_SMEM_RESERVED = 233472, 1024
_SM_THREADS, _SM_REGS = 2048, 65536
_FWD_REGS = {1: 96, 2: 106, 4: 128}
_SPLIT_REGS = {"ntt_fwd": _FWD_REGS, "ntt_fwd_tail": _FWD_REGS,
               "ntt_inv": {1: 88, 2: 90, 4: 94},
               "ntt_fwd_mac": {1: 128, 2: 128, 4: 128}}
# a block's dynamic shared memory at most on sm_90 (opted in), in bytes
_BLOCK_SMEM = 232448
MAC_COMPONENTS = 2  # KeySwitch's key components: the MAC's shape by default


def split_threads(n: int, parts: int) -> int:
    """Threads of a split block (csrc/ntt_kernels.cu, split_threads)."""
    return max(1, min(SPLIT_THREADS, (n // parts) >> SPLIT_R))


def _piece_smem(length: int) -> int:
    """Bytes of a piece of `length` values in shared memory (one spare u64
    every 16, csrc/ntt_kernels.cuh spad)."""
    return 8 * (length + (length - 1) // 16)


def mac_chunk(n: int, parts: int, comp: int) -> int:
    """Key components whose accumulators ntt_fwd_mac keeps beside a piece of
    n/parts values in one block's shared memory (at most comp; 0 if not even
    one fits; csrc/ntt_kernels.cu, mac_chunk)."""
    length = n // parts
    return min(comp, (_BLOCK_SMEM - _piece_smem(length)) // (8 * length))


def split_smem(kernel: str, n: int, parts: int) -> int:
    """Dynamic shared memory bytes of one block of `kernel` at (n, parts)
    (ntt_fwd_mac with MAC_COMPONENTS components)."""
    smem = _piece_smem(n // parts)
    if kernel == "ntt_fwd_mac":
        smem += 8 * (n // parts) * mac_chunk(n, parts, MAC_COMPONENTS)
    return smem


def split_blocks_per_sm(n: int, parts: int, kernel: str = "ntt_fwd") -> int:
    """The model's blocks of `kernel` resident on one SM, by shared memory,
    threads and registers."""
    threads = split_threads(n, parts)
    regs = -(-threads * _SPLIT_REGS[kernel][parts] // 256) * 256  # allocation unit
    return max(1, min(
        _SM_SMEM // (split_smem(kernel, n, parts) + _BLOCK_SMEM_RESERVED),
        _SM_THREADS // threads, _SM_REGS // regs, 32))


def piece_fits(n: int, parts: int) -> bool:
    """A piece of n/parts values fits one block's shared memory (at
    n = 32768 not the whole row: 278,520 bytes)."""
    return _piece_smem(n // parts) <= _BLOCK_SMEM


def split_candidates(n: int, kernel: str = "ntt_fwd") -> list:
    """The parts a row of n may be split into: of those whose piece fits one
    block's shared memory, 1, and 2 or 4 while each piece still gives a block
    its full threads (n/parts >= SPLIT_THREADS * 2^SPLIT_R values; smaller
    pieces make smaller blocks, not faster ones); for ntt_fwd_mac only those
    whose piece leaves room for one component's accumulators."""
    cands = [p for p in (1, 2, 4) if piece_fits(n, p)
             and (p == 1 or n // p >= SPLIT_THREADS << SPLIT_R)]
    if kernel == "ntt_fwd_mac":
        cands = [p for p in cands if mac_chunk(n, p, 1) >= 1]
    return cands


@functools.lru_cache(maxsize=None)
def _split_slots(n: int, parts: int, device_index, kernel: str) -> int:
    """Blocks of `kernel` at (n, parts) that run at once: SMs times resident
    blocks per SM, of CUDA device `device_index`, or of the model for None."""
    if device_index is None:
        return H100_SM_COUNT * split_blocks_per_sm(n, parts, kernel)
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    per_sm = split_info(kernel, n, parts, device_index)["blocks_per_sm"]
    return sms * max(1, per_sm)


@functools.lru_cache(maxsize=None)
def _row_split(rows: int, n: int, device_index, kernel: str) -> int:
    def waves(parts):
        return -(-rows * parts // _split_slots(n, parts, device_index, kernel))

    cands = split_candidates(n, kernel)
    one_wave = [p for p in cands if waves(p) == 1]
    if one_wave:
        return one_wave[-1]
    return min(cands, key=lambda p: (waves(p) / p, p))


def _device_index(device):
    """None for a CPU (the model), else the CUDA device's index."""
    device = torch.device("cpu" if device is None else device)
    if device.type != "cuda":
        return None
    return torch.cuda.current_device() if device.index is None else device.index


def row_split(rows: int, n: int, device=None, kernel: str = "ntt_fwd") -> int:
    """The parts per row `kernel` (a split kernel) launches for (rows, n) on
    `device`, among split_candidates(n, kernel): the largest C whose rows * C
    blocks take one wave; where none does, the C whose waves end soonest if
    each takes the time of one block of n/C values (the least ceil(waves) /
    C; a tie goes to the smaller C, which crosses fewer stages).  The waves
    count the kernel's own resident blocks per SM: a CUDA device's figures, a
    CPU's or None's the model's.  Cached."""
    return _row_split(rows, n, _device_index(device), kernel)


# ntt_fwd_mac's blocks that share a row's source limbs: a cluster of two,
# each summing every other limb, the pair's sums added through distributed
# shared memory.  Measured against one block that sums every limb (one
# cluster of 1) and one block per limb (a cluster of all of them) at the
# fused-MAC body's shapes, it was the fastest (PERF.md §6): pairs fill all
# 132 SMs where clusters of 3, 5 or 6 blocks of 200 KB leave 15 to 30 idle,
# and a lone block needs C = 4 to fill the card, whose crossing costs more.
MAC_CLUSTER = 2


def mac_split(B: int, limbs: int, n: int, device=None) -> tuple:
    """(parts, cluster) of ntt_fwd_mac for B batch rows summed over `limbs`
    source limbs on `device`: clusters of MAC_CLUSTER blocks (fewer if fewer
    limbs), and the parts row_split gives that many blocks' rows (B times
    the cluster) of this kernel.  Cached with row_split."""
    cluster = min(MAC_CLUSTER, limbs)
    return row_split(B * cluster, n, device, "ntt_fwd_mac"), cluster


# ---------------------------------------------------------------------------
# kernel binding
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load(KERNEL_SOURCE, KERNEL_DEPS)
    p, u, i = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int
    lib.hexl_ntt_fwd.argtypes = [p, p, p, i, i, u, u, i, p]
    lib.hexl_ntt_inv.argtypes = [p, p, p, i, i, u, u, u, u, u, u, i, p]
    lib.hexl_ntt_fwd_tail.argtypes = [p, p, p, p, p, i, i, u, u, u, u, u, i, p]
    lib.hexl_ntt_fwd_mac.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, u, u,
                                     i, i, p]
    ll = ctypes.c_longlong
    lib.hexl_keyswitch_mac.argtypes = [p, p, p, p, i, i, i, i, ll, ll, ll, ll,
                                       ll, ll, ll, ll, u, i, p]
    for fn in (lib.hexl_ntt_fwd, lib.hexl_ntt_inv, lib.hexl_ntt_fwd_tail,
               lib.hexl_ntt_fwd_mac, lib.hexl_keyswitch_mac,
               lib.hexl_ntt_split_info):
        fn.restype = ctypes.c_int
    lib.hexl_ntt_split_info.argtypes = [i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
    return lib


def build_kernels() -> None:
    """Compile and load the kernels now (otherwise done at first launch)."""
    _lib()


def split_info(kernel: str, n: int, parts: int, device_index: int = 0,
               cluster: int = 1) -> dict:
    """What CUDA device `device_index` made of a split kernel (one of
    SPLIT_KERNELS; ntt_fwd_mac with MAC_COMPONENTS components in clusters of
    `cluster` blocks) at (n, parts): registers and local (spill) bytes per
    thread, threads per block, resident blocks per SM, dynamic shared memory
    bytes per block, and for cluster > 1 the clusters it runs at once."""
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device_index):
        err = _lib().hexl_ntt_split_info(SPLIT_KERNELS.index(kernel), parts, n,
                                         MAC_COMPONENTS, cluster, out)
    if err != 0:
        raise RuntimeError(f"split_info({kernel}, {n}, {parts}): cudaError {err}")
    return dict(zip(("registers", "local_bytes", "threads", "blocks_per_sm",
                     "smem_bytes", "clusters"), out))


def _check(x: torch.Tensor, tabs: ModulusTables, name: str,
           forward: bool = True) -> None:
    if not (tabs.has_fwd if forward else tabs.has_inv):
        raise ValueError(
            f"{name}: these tables hold no "
            f"{'forward' if forward else 'inverse'} twiddles"
        )
    if x.dtype != torch.int64:
        raise TypeError(f"{name}: expected int64 bit patterns, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != tabs.n or x.shape[0] < 1:
        raise ValueError(f"{name}: expected (rows >= 1, {tabs.n}), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if x.device != tabs.tab.device:
        raise ValueError(
            f"{name}: tensor on {x.device}, tables on {tabs.tab.device}"
        )


def _launch(name: str, entry, x: torch.Tensor, *args) -> None:
    """Call one C entry on x's device and current stream; raise if the launch
    was refused."""
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = entry(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")
    with _launches_lock:
        LAUNCHES[name] += 1
    mine = getattr(_this_thread, "counts", None)
    if mine is not None:
        mine[name] += 1


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _fwd_stages_plain(x: torch.Tensor, tabs: ModulusTables, parts: int,
                      part: int) -> torch.Tensor:
    """Forward stages on rows (R, len) of values < 4q; returns values in
    [0, 4q).  With parts = 1 the rows are whole and these are all stages; with
    parts > 1 they are piece `part` of rows of parts * len whose stages
    m < parts are done, and stage ml here is stage parts * ml of the whole
    row: its twiddles start at (parts + part) * ml (`csrc/ntt_kernels.cuh`,
    fwd_pass's `tw`)."""
    q = tabs.q
    R, n = x.shape
    fwd, fwd_p = tabs.tab[0], tabs.tab[1]
    tw = parts + part
    t, m = n >> 1, 1
    while m < n:
        v = x.view(R, m, 2, t)
        W = fwd[tw * m : tw * m + m].view(1, m, 1)
        Wp = fwd_p[tw * m : tw * m + m].view(1, m, 1)
        tx = w.cond_sub64(v[:, :, 0, :], 2 * q)
        T = w.mul_mod_lazy(v[:, :, 1, :], W, Wp, q)
        x = torch.stack([tx + T, tx + 2 * q - T], dim=2).view(R, n)
        m <<= 1
        t >>= 1
    return x


def _fwd_split_plain(x: torch.Tensor, tabs: ModulusTables,
                     parts: int) -> torch.Tensor:
    """The split kernels' schedule on canonical rows (R, n) held as `parts`
    contiguous pieces: the log2(parts) stages that cross the pieces (stage m
    pairs piece c with c + parts/2m under twiddle m + c // (parts/m)), then
    each piece's stages on its own (`csrc/ntt_kernels.cuh`, fwd_cross and
    fwd_split)."""
    q = tabs.q
    R, n = x.shape
    pieces = list(x.view(R, parts, n // parts).unbind(1))
    m = 1
    while m < parts:
        h = parts // (2 * m)
        for c in range(parts):
            if c & h:
                continue
            W, Wp = tabs.tab[0, m + c // (2 * h)], tabs.tab[1, m + c // (2 * h)]
            tx = w.cond_sub64(pieces[c], 2 * q)
            T = w.mul_mod_lazy(pieces[c + h], W, Wp, q)
            pieces[c], pieces[c + h] = tx + T, tx + 2 * q - T
        m <<= 1
    return torch.cat(
        [_fwd_stages_plain(p.contiguous(), tabs, parts, c)
         for c, p in enumerate(pieces)], dim=1)


def _reduce4(x, q: int):
    return w.cond_sub64(w.cond_sub64(x, 2 * q), q)


def _parts(x: torch.Tensor, tabs: ModulusTables, parts, kernel: str) -> int:
    """The parts of a call of a split kernel: a caller's, checked, or the
    kernel's own row_split."""
    if parts is None:
        return row_split(x.shape[0], tabs.n, x.device, kernel)
    if parts not in (1, 2, 4) or 2 * parts > tabs.n:
        raise ValueError(f"parts must be 1, 2 or 4 and at most n/2, got {parts}")
    if not piece_fits(tabs.n, parts):
        raise ValueError(
            f"parts = {parts} at n = {tabs.n}: a piece of {tabs.n // parts} "
            f"values takes {_piece_smem(tabs.n // parts)} bytes, more than one "
            f"block's {_BLOCK_SMEM} bytes of shared memory")
    return parts


def ntt_fwd_plain(x: torch.Tensor, tabs: ModulusTables,
                  parts: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of ntt_fwd (any device), on the kernel's split:
    `parts` pieces per row, by default what ntt_fwd launches (row_split).
    Every split gives the same bits."""
    _check(x, tabs, "ntt_fwd_plain")
    parts = _parts(x, tabs, parts, "ntt_fwd")
    x = w.barrett_canonical(x, tabs.q, tabs.q_barr)
    return _reduce4(_fwd_split_plain(x, tabs, parts), tabs.q)


def ntt_fwd(x: torch.Tensor, tabs: ModulusTables,
            parts: int | None = None) -> torch.Tensor:
    """Forward negacyclic NTT of each row of x (R, n) int64 under tabs.q:
    NTT(x mod q), bit-reversed order, canonical.  x may hold any u64.
    `parts` (1, 2 or 4, a piece fitting one block's shared memory) overrides
    row_split's blocks per row."""
    _check(x, tabs, "ntt_fwd")
    if x.device.type == "cpu":
        return ntt_fwd_plain(x, tabs, parts)
    parts = _parts(x, tabs, parts, "ntt_fwd")
    out = torch.empty_like(x)
    _launch("ntt_fwd", _lib().hexl_ntt_fwd, x, x.data_ptr(), out.data_ptr(),
            tabs.tab.data_ptr(), x.shape[0], tabs.n, tabs.q, tabs.q_barr, parts)
    return out


# ---------------------------------------------------------------------------
# inverse
# ---------------------------------------------------------------------------


def _inv_stage_plain(x: torch.Tensor, tabs: ModulusTables, m: int,
                     root: int) -> torch.Tensor:
    """One inverse stage on rows (R, len) of values < 2q, which stay < 2q:
    m groups of distance len / 2m, group j under twiddle root + j."""
    q = tabs.q
    R, length = x.shape
    v = x.view(R, m, 2, length // (2 * m))
    W = tabs.tab[2, root : root + m].view(1, m, 1)
    Wp = tabs.tab[3, root : root + m].view(1, m, 1)
    X, Y = v[:, :, 0, :], v[:, :, 1, :]
    return torch.stack(
        [w.cond_sub64(X + Y, 2 * q), w.mul_mod_lazy(X + 2 * q - Y, W, Wp, q)],
        dim=2,
    ).view(R, length)


def _inv_split_plain(x: torch.Tensor, tabs: ModulusTables,
                     parts: int) -> torch.Tensor:
    """The split inverse kernel's schedule on canonical rows (R, n): the
    log2(parts) stages that cross the pieces (the row's first: distance
    t < parts), then piece c, the values at c, c + parts, ..., alone through
    the row's stages m = n / 2parts .. 2 under the row's twiddles n - 2m + 1 +
    group (`csrc/ntt_kernels.cuh`, inv_cross and inv_split).  The last stage
    (m = 1, inside each piece) is the caller's."""
    R, n = x.shape
    m = n >> 1
    while m >= n // parts:
        x = _inv_stage_plain(x, tabs, m, n - 2 * m + 1)
        m >>= 1
    pieces = x.view(R, n // parts, parts).transpose(1, 2).reshape(R * parts, -1)
    while m >= 2:
        pieces = _inv_stage_plain(pieces, tabs, m, n - 2 * m + 1)
        m >>= 1
    return pieces.view(R, parts, n // parts).transpose(1, 2).reshape(R, n)


def ntt_inv_plain(x: torch.Tensor, tabs: ModulusTables,
                  parts: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of ntt_inv (any device), on the kernel's split:
    `parts` strided pieces per row, by default what ntt_inv launches
    (row_split).  Every split gives the same bits."""
    _check(x, tabs, "ntt_inv_plain", forward=False)
    parts = _parts(x, tabs, parts, "ntt_inv")
    q, h = tabs.q, tabs.n >> 1
    x = _inv_split_plain(w.barrett_canonical(x, q, tabs.q_barr), tabs, parts)
    # last stage fused with the n^-1 scaling
    X, Y = x[:, :h], x[:, h:]
    tx = w.cond_sub64(X + Y, 2 * q)
    ty = X + 2 * q - Y
    lo = w.mul_mod_lazy(tx, tabs.inv_n, tabs.inv_n_precon, q)
    hi = w.mul_mod_lazy(ty, tabs.inv_n_w, tabs.inv_n_w_precon, q)
    return w.cond_sub64(torch.cat([lo, hi], dim=1), q)


def ntt_inv(x: torch.Tensor, tabs: ModulusTables,
            parts: int | None = None) -> torch.Tensor:
    """Inverse negacyclic NTT of each row of x (R, n) int64 under tabs.q:
    bit-reversed in, natural out, scaled by n^-1, canonical.  The canonical
    output matters: callers re-reduce its integer value under other moduli.
    `parts` as in ntt_fwd."""
    _check(x, tabs, "ntt_inv", forward=False)
    if x.device.type == "cpu":
        return ntt_inv_plain(x, tabs, parts)
    parts = _parts(x, tabs, parts, "ntt_inv")
    out = torch.empty_like(x)
    args = (x.data_ptr(), out.data_ptr(), tabs.tab.data_ptr(), x.shape[0],
            tabs.n, tabs.q, tabs.q_barr, tabs.inv_n, tabs.inv_n_precon,
            tabs.inv_n_w, tabs.inv_n_w_precon)
    _launch("ntt_inv", _lib().hexl_ntt_inv, x, *args, parts)
    return out


# ---------------------------------------------------------------------------
# keyswitch tail
# ---------------------------------------------------------------------------


def ntt_fwd_tail_plain(e, acc, res, tabs: ModulusTables, fix: int, msf: int,
                       msf_precon: int, parts: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of ntt_fwd_tail (any device), on the kernel's
    split (`parts` as in ntt_fwd_plain)."""
    for name, x in (("e", e), ("acc", acc), ("res", res)):
        _check(x, tabs, f"ntt_fwd_tail_plain({name})")
    q = tabs.q
    parts = _parts(e, tabs, parts, "ntt_fwd_tail")
    g = ntt_fwd_plain(w.add64(e, fix), tabs, parts)
    a = w.barrett_canonical(acc, q, tabs.q_barr)
    t1 = w.reduce_mod_factor(w.add64(w.sub64(a, g), 4 * q), q, 8)
    delta = w.cond_sub64(w.mul_mod_lazy(t1, msf, msf_precon, q), q)
    return w.cond_sub64(w.add64(res, delta), q)


def ntt_fwd_tail(e, acc, res, tabs: ModulusTables, fix: int, msf: int,
                 msf_precon: int, parts: int | None = None) -> torch.Tensor:
    """Keyswitch tail for one decomp modulus q, one pass over (R, n) rows:

        g = NTT_q(e + fix)                  e + fix may be any u64
        t1 = ReduceMod8((acc mod q) + 4q - g)   acc: any lazy u64 sum
        out = cond_sub(res + t1 * msf mod q, q)

    msf < q with msf_precon = floor(msf << 64 / q) are runtime scalars.  The
    single conditional subtract makes out canonical exactly when res < q; a
    caller's out-of-range res passes through as in the reference.  `parts`
    as in ntt_fwd."""
    for name, x in (("e", e), ("acc", acc), ("res", res)):
        _check(x, tabs, f"ntt_fwd_tail({name})")
    if e.shape != acc.shape or e.shape != res.shape:
        raise ValueError("ntt_fwd_tail: e, acc, res must share one shape")
    if e.device.type == "cpu":
        return ntt_fwd_tail_plain(e, acc, res, tabs, fix, msf, msf_precon, parts)
    parts = _parts(e, tabs, parts, "ntt_fwd_tail")
    out = torch.empty_like(e)
    _launch("ntt_fwd_tail", _lib().hexl_ntt_fwd_tail, e, e.data_ptr(),
            acc.data_ptr(), res.data_ptr(), out.data_ptr(),
            tabs.tab.data_ptr(), e.shape[0], tabs.n, tabs.q, tabs.q_barr,
            int(fix), int(msf), int(msf_precon), parts)
    return out


# ---------------------------------------------------------------------------
# keyswitch engine: forward transform fused with the key MAC
# ---------------------------------------------------------------------------


def _check_mac(data, keys, kp, j: int, tabs: ModulusTables, skip_i,
               name: str):
    """Validate an engine call; returns (L, comp, K, B)."""
    _check(data, tabs, f"{name}(data)")
    if keys.dim() != 4 or keys.shape[3] != tabs.n or keys.shape != kp.shape:
        raise ValueError(
            f"{name}: keys and precons must share one (L, comp, K, {tabs.n}) "
            f"shape, got {tuple(keys.shape)} and {tuple(kp.shape)}"
        )
    L, comp, K, _ = keys.shape
    for what, x in (("keys", keys), ("precons", kp)):
        if x.dtype != torch.int64 or not x.is_contiguous():
            raise TypeError(f"{name}: {what} must be contiguous int64")
        if x.device != data.device:
            raise ValueError(f"{name}: {what} on {x.device}, data on {data.device}")
    if data.shape[0] % L:
        raise ValueError(
            f"{name}: {data.shape[0]} data rows do not split into {L} source limbs"
        )
    if not 0 <= j < K:
        raise ValueError(f"{name}: key column {j} outside [0, {K})")
    if skip_i is not None:
        if not 0 <= skip_i < L:
            raise ValueError(f"{name}: skip_i {skip_i} outside [0, {L})")
        if L < 2:
            raise ValueError(
                f"{name}: skip_i needs L >= 2 (at L == 1 the only source limb "
                f"is the skipped one and no term is left to sum)"
            )
    return L, comp, K, data.shape[0] // L


def _mac_shape(data, tabs: ModulusTables, B: int, limbs: int, parts,
               cluster) -> tuple:
    """(parts, cluster) of an engine call: each a caller's, checked, or
    mac_split's."""
    chosen = mac_split(B, limbs, tabs.n, data.device)
    if parts is None:
        parts = chosen[0]
    else:
        parts = _parts(data, tabs, parts, "ntt_fwd_mac")
        if mac_chunk(tabs.n, parts, 1) < 1:
            raise ValueError(f"ntt_fwd_mac: a piece of {tabs.n // parts} values "
                             f"leaves no shared memory for the sums")
    if cluster is None:
        cluster = chosen[1]
    if not 1 <= cluster <= min(8, limbs):
        raise ValueError(f"ntt_fwd_mac: cluster must be 1 .. min(8, {limbs} "
                         f"summed limbs), got {cluster}")
    return parts, cluster


def ntt_fwd_mac_plain(data, keys, kp, j: int, tabs: ModulusTables,
                      skip_i: int | None = None,
                      parts: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of ntt_fwd_mac (any device): canonical forward
    transform on the kernel's split (`parts` as in ntt_fwd_mac), Harvey lazy
    multiply by the key column, wrapping sum over the source limbs (the order
    of a wrapping sum does not change its bits, so the kernel's grouping of
    the limbs has no counterpart here)."""
    L, comp, K, B = _check_mac(data, keys, kp, j, tabs, skip_i,
                               "ntt_fwd_mac_plain")
    if parts is None:
        parts = mac_split(B, L - (skip_i is not None), tabs.n, data.device)[0]
    val = ntt_fwd_plain(data, tabs, parts).view(L, 1, B, tabs.n)
    terms = w.mul_mod_lazy(val, keys[:, :, j, None, :], kp[:, :, j, None, :],
                           tabs.q)  # (L, comp, B, n), each in [0, 2q)
    if skip_i is not None:
        terms = terms[[i for i in range(L) if i != skip_i]]
    return terms.sum(0)


def ntt_fwd_mac(data, keys, kp, j: int, tabs: ModulusTables,
                skip_i: int | None = None, parts: int | None = None,
                cluster: int | None = None) -> torch.Tensor:
    """Keyswitch engine for one modulus q = tabs.q, key column j:

        out[k, b] = sum over i != skip_i of
                    lazy(NTT_q(data[i*B + b] mod q) * keys[i, k, j])

    data (L*B, n) int64, i-major (rows i*B .. i*B+B-1 are source limb i), any
    u64 representative; keys, kp the whole staged (L, comp, K, n) key and
    precon tensors (no copy of the column is made); out (comp, B, n), a
    wrapping u64 sum of terms in [0, 2q), so out < 2*L*q.  skip_i names the
    identity limb whose term the caller adds itself; it needs L >= 2.
    `parts` (blocks per row) and `cluster` (blocks that share the limbs)
    override mac_split's launch shape."""
    L, comp, K, B = _check_mac(data, keys, kp, j, tabs, skip_i, "ntt_fwd_mac")
    parts, cluster = _mac_shape(data, tabs, B, L - (skip_i is not None), parts,
                                cluster)
    if data.device.type == "cpu":
        return ntt_fwd_mac_plain(data, keys, kp, j, tabs, skip_i, parts)
    out = torch.empty((comp, B, tabs.n), dtype=torch.int64, device=data.device)
    _launch("ntt_fwd_mac", _lib().hexl_ntt_fwd_mac, data, data.data_ptr(),
            keys.data_ptr(), kp.data_ptr(), out.data_ptr(),
            tabs.tab.data_ptr(), L, B, comp, K, j,
            -1 if skip_i is None else skip_i, tabs.n, tabs.q, tabs.q_barr,
            parts, cluster)
    return out


# ---------------------------------------------------------------------------
# keyswitch engine's lazy key MAC, on limbs already transformed
# ---------------------------------------------------------------------------
#
# The default schedule transforms an engine's source limbs with ntt_fwd and
# then sums them against the key column.  No TPU kernel has this MAC: the
# reference composes it in XLA (`keyswitch_tpu._mac_term`, `_mac_close`), and
# so did the torch glue here, about 20 elementwise and reduce launches an
# engine over (L, comp, B, n) intermediates.  Bytes bound it: it reads the
# limbs once, the key and precon column once (their rows are L2 hits for
# every batch row after the first), and writes the sums once; its 32-bit
# multiply-adds take well under half that time on an H100.  The kernel keeps
# both components' sums in registers over the limbs, so each limb value is
# read once for every component.


def _check_keyswitch_mac(val, key, kp, q: int, name: str) -> int:
    """Validate a MAC call; returns B, the batch rows of the output."""
    if val.dim() != 3 or key.dim() != 4 or key.shape != kp.shape:
        raise ValueError(
            f"{name}: expected val (L, B, n) and key, precons one (L, comp, B, n) "
            f"shape, got {tuple(val.shape)}, {tuple(key.shape)}, {tuple(kp.shape)}")
    L, Bv, n = val.shape
    if L < 1 or key.shape[0] != L or key.shape[3] != n:
        raise ValueError(f"{name}: val {tuple(val.shape)} and key "
                         f"{tuple(key.shape)} disagree on limbs or n")
    if not 1 <= key.shape[1] <= MAC_COMPONENTS:
        raise ValueError(f"{name}: 1 to {MAC_COMPONENTS} key components, "
                         f"got {key.shape[1]}")
    B = max(Bv, key.shape[2])
    if {Bv, key.shape[2]} - {1, B}:
        raise ValueError(f"{name}: batch rows {Bv} and {key.shape[2]} do not "
                         f"broadcast (each must be 1 or {B})")
    for what, x in (("val", val), ("keys", key), ("precons", kp)):
        if x.dtype != torch.int64:
            raise TypeError(f"{name}: {what} must be int64 bit patterns, got {x.dtype}")
        if x.device != val.device:
            raise ValueError(f"{name}: {what} on {x.device}, val on {val.device}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: {what} must be contiguous along n")
    if not 1 < int(q) < (1 << 64):
        raise ValueError(f"{name}: q must be a modulus below 2^64, got {q}")
    return B


def keyswitch_mac_plain(val, key, kp, q: int) -> torch.Tensor:
    """Plain PyTorch version of keyswitch_mac (any device): the torch
    composition the kernel replaces.  Harvey lazy MAC terms with the
    APPROXIMATE quotient (word64.mulhi64_approx) and the Q*q subtraction
    DEFERRED across the sum: sum(key*val mod 2^64) - (sum Q)*q, once."""
    _check_keyswitch_mac(val, key, kp, q, "keyswitch_mac_plain")
    val = val[:, None]  # (L, 1, Bv, n)
    wx, Q = w.mullo64(key, val), w.mulhi64_approx(val, kp)
    return w.sub64(wx.sum(0), w.mullo64(Q.sum(0), q))


def _row_stride(x: torch.Tensor, dim: int) -> int:
    """x's stride along dim in words, 0 where the dim is broadcast (size 1)."""
    return x.stride(dim) if x.shape[dim] > 1 else 0


def keyswitch_mac(val, key, kp, q: int) -> torch.Tensor:
    """Lazy key MAC of one engine modulus q over L transformed source limbs:

        out[k, b] = sum_i key[i, k, b] * val[i, b]  -  (sum_i Q_i) * q   mod 2^64
        Q_i = mulhi64_approx(val[i, b], kp[i, k, b])

    val (L, Bv, n) and key, kp (L, comp, Bk, n) int64, Bv and Bk each 1 or B
    (a key row shared by every batch row, or one each), any strides with n
    contiguous; out (comp, B, n), contiguous.  With key < q, kp its Harvey
    precon, val any u64, q <= 2^52 and L <= 7 the true sum of the terms is
    below 28q, so out is that lazy sum exactly."""
    B = _check_keyswitch_mac(val, key, kp, q, "keyswitch_mac")
    if val.device.type == "cpu":
        return keyswitch_mac_plain(val, key, kp, q)
    L, comp, _, n = key.shape
    out = torch.empty((comp, B, n), dtype=torch.int64, device=val.device)
    strides = (val.stride(0), _row_stride(val, 1),
               key.stride(0), key.stride(1), _row_stride(key, 2),
               kp.stride(0), kp.stride(1), _row_stride(kp, 2))
    # 16-byte accesses where every row starts on 16 bytes
    vec = 2 if (n % 2 == 0 and all(s % 2 == 0 for s in strides)
                and all(x.data_ptr() % 16 == 0 for x in (val, key, kp))) else 1
    _launch("keyswitch_mac", _lib().hexl_keyswitch_mac, val, val.data_ptr(),
            key.data_ptr(), kp.data_ptr(), out.data_ptr(), L, comp, B, n,
            *strides, int(q), vec)
    return out


# ---------------------------------------------------------------------------
# numpy conveniences
# ---------------------------------------------------------------------------


def _run_np(fn, a, q: int, device) -> np.ndarray:
    a = np.asarray(a, dtype=np.uint64)
    n = a.shape[-1]
    tabs = modulus_tables(n, q, device=device)
    x = w.from_u64_np(a.reshape(-1, n), device)
    return w.to_u64_np(fn(x, tabs)).reshape(a.shape)


def fwd_ntt(a, q: int, device="cuda") -> np.ndarray:
    """Forward NTT of u64 rows (..., n) under q, canonical output."""
    return _run_np(ntt_fwd, a, q, device)


def inv_ntt(a, q: int, device="cuda") -> np.ndarray:
    """Inverse NTT of u64 rows (..., n) under q, canonical output."""
    return _run_np(ntt_inv, a, q, device)
