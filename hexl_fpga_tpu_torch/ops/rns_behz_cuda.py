"""BEHZ full-RNS BFV multiply on the card.

The counterpart of `hexl_fpga_tpu/ops/rns_behz_tpu.py` (`BehzTpu`): the
pipeline of the host `rns_behz.BehzTool.multiply`, composed of the port's
kernels and torch lane math on int64 bit patterns (`word64`):

  * inverse / forward transforms -> `ntt_cuda.ntt_inv` / `ntt_fwd`, one launch
                                   per modulus over the stacked rows: the four
                                   input polynomials (4B rows) or the three
                                   tensor components (3B rows);
  * the tensor product           -> one `dyadic_cuda.dyadic_multiply` launch
                                   over the 2k + 1 moduli of q u Bsk (the q
                                   half the input limbs, the Bsk half the
                                   transformed extension): the reference
                                   writes it as lane math (`_tensor`), and it
                                   is exactly the 2x2 -> 3 product B4 computes;
  * base extension + SmMRq       -> one `behz_extend` launch, and fast floor +
  * fast floor + Shenoy-Kumaresan   Shenoy-Kumaresan one `behz_floor_sk` launch
                                   (`csrc/behz_kernels.cu`): a thread takes a
                                   coefficient column through the whole
                                   conversion in registers (in a scratch
                                   tensor above MAX_K moduli), its constants
                                   one packed table per object (`_pack`); on
                                   the CPU the plain versions: torch ops in
                                   which every constant multiply is a Harvey
                                   lazy multiply against a precon computed
                                   here (exact in [0, 2m) for any u64
                                   operand), and each fast base conversion is
                                   ONE lazy multiply of the (k, R, n) limbs by
                                   a (k, D, 1, 1) constant tensor, summed over
                                   the source limbs and reduced once
                                   (`kernel_path` decides);
  * m_tilde = 2^32 arithmetic    -> uint32 in the kernel; in the plain version
                                   int64 ops on the low 32 bits, masked after
                                   every product and sum (wrapping int64
                                   multiplication agrees with uint32 there).

Every step ends canonical, as in the host tool and the reference's device
module, so the three give the same bits.  The port serves any n of its
transform kernels and every modulus below 2^62 (the reference's MXU plan
stops at 2^55): a lazy conversion sum is reduced before it could reach 2^64.

`BehzCuda.multiply_tensors` is the composition (the reference's
`_multiply_pairs`); `program(B)` replays it as one captured CUDA graph on the
card (the reference jits it into one program), and `multiply_batch` /
`multiply` take and give u64 numpy arrays through it.  `GRAPHS` counts the
multiply bodies by how they ran, `LAUNCHES` the two conversion kernels.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from . import _build, dyadic_cuda, ntt_cuda, rns_behz, twiddles, word64 as w
from ..utils.graph import GraphProgram

_M32 = 0xFFFFFFFF

# multiply bodies by how they ran: a program captured (once per batch size),
# replayed, or launched one by one (`multiply_tensors`, and a program's call
# off the card); the capture's own run and its warm-up are not bodies.
# Counted across the process, as keyswitch_cuda.GRAPHS counts dispatch_batch's
GRAPHS = {"captures": 0, "replays": 0, "eager": 0}
_graphs_count_lock = threading.Lock()


def _count(kind: str) -> None:
    with _graphs_count_lock:
        GRAPHS[kind] += 1


# launches of the conversion kernels since the last reset; a wrapper adds one
# exactly where it launches its kernel (ntt_cuda.count_launch, under its lock)
LAUNCHES = {"behz_extend": 0, "behz_floor_sk": 0}

KERNEL_SOURCE = "behz_kernels.cu"

# the most q moduli the kernels hold in registers (BEHZ_MAX_K of the source);
# above it they keep a column's limbs in a scratch tensor
MAX_K = 8


def reset_launch_counts() -> None:
    with ntt_cuda._launches_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def fits(tool: rns_behz.BehzTool) -> bool:
    """Whether the port's kernels serve tool's shape: n and every modulus of
    q u Bsk as `ntt_cuda` accepts them (a power-of-two n up to MAX_N, moduli
    below 2^62).  Decided by the shape alone, before anything is built."""
    try:
        for m in tool.q + tool.Bsk:
            ntt_cuda._check_n_q(tool.n, m)
    except ValueError:
        return False
    return True


@dataclass(frozen=True, eq=False)
class _Harvey:
    """Constants c (reduced mod q) with their precons floor(c << 64 / q) and
    the moduli q, as int64 tensors that broadcast against (..., rows, n)."""

    c: torch.Tensor
    pre: torch.Tensor
    q: torch.Tensor

    @classmethod
    def of(cls, c, q, device) -> "_Harvey":
        c = np.asarray(c, dtype=object)
        shape = c.shape + (1, 1)
        q = np.broadcast_to(np.asarray(q, dtype=object), c.shape)
        c = c % q

        def dev(a):
            return w.from_u64_np(np.asarray(a, dtype=object).astype(np.uint64)
                                 .reshape(shape), device)

        return cls(dev(c), dev((c << 64) // q), dev(q))

    def lazy(self, x):
        """x * c mod q in [0, 2q), for any u64 x."""
        return w.mul_mod_lazy(x, self.c, self.pre, self.q)

    def __call__(self, x):
        """x * c mod q, canonical."""
        return w.cond_sub64(self.lazy(x), self.q)


def _col(values, device) -> torch.Tensor:
    """Moduli (or other u64 constants) as a (len, 1, 1) int64 tensor."""
    return w.from_u64_np(np.array([int(v) for v in values], dtype=np.uint64)
                         .reshape(-1, 1, 1), device)


class _Conversion:
    """A fast base conversion sum_i x_i * C[i, d] mod m_d: the (k, R, n)
    source limbs times a (k, D) constant matrix, one lazy multiply for every
    term, then a sum over i and one Barrett reduction per destination.  Lazy
    terms are below 2m, so at most `group` of them are added before a
    reduction: their sum stays below 2^64 for every modulus below 2^62."""

    def __init__(self, consts, moduli: Sequence[int], device):
        moduli = [int(m) for m in moduli]
        self.mul = _Harvey.of(consts, [moduli], device)  # (k, D, 1, 1)
        self.q = _col(moduli, device)
        self.barr = _col([(1 << 64) // m for m in moduli], device)
        self.group = ((1 << 64) - 1) // (2 * max(moduli) - 1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(k, R, n) limbs (any u64) -> (D, R, n) canonical."""
        terms = self.mul.lazy(x[:, None])  # (k, D, R, n), each below 2m
        while terms.shape[0] > self.group:
            terms = torch.stack([
                w.barrett_canonical(terms[i : i + self.group].sum(0), self.q, self.barr)
                for i in range(0, terms.shape[0], self.group)])
        return w.barrett_canonical(terms.sum(0), self.q, self.barr)


# -- the conversion kernels (csrc/behz_kernels.cu) ----------------------------


def kernel_path(device) -> bool:
    """Whether BehzCuda's conversions run as the two kernels (tensors on a
    CUDA device, at every k) or as the plain torch lane math (on the CPU)."""
    return torch.device(device).type == "cuda"


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load(KERNEL_SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hexl_behz_extend.argtypes = [p, p, ll, p, p, i, ll, p]
    lib.hexl_behz_floor_sk.argtypes = [p, p, p, ll, p, p, i, ll, p]
    for fn in (lib.hexl_behz_extend, lib.hexl_behz_floor_sk):
        fn.restype = ctypes.c_int
    return lib


def build_kernels() -> None:
    """Compile and load the kernels now (otherwise done at first launch)."""
    _lib()


def _launch(name: str, *args) -> None:
    """ntt_cuda._launch of the C entry hexl_<name> on the device of its first
    argument, tensors by pointer (None as NULL), counted in LAUNCHES."""
    ntt_cuda._launch(name, getattr(_lib(), f"hexl_{name}"), args[0],
                     *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
                     table=LAUNCHES)


def _check_limbs(name: str, table: torch.Tensor, x: torch.Tensor, *more) -> int:
    """Validate a conversion's (k, R, n) input x, its other inputs `more` as
    (tensor, e) pairs of k + e limbs over x's (R, n), and the table's type
    (the kernel refuses a table not of k's size); returns k."""
    if x.dim() != 3 or x.shape[0] < 1:
        raise ValueError(f"{name}: expected (k, R, n) limbs with k >= 1, got "
                         f"{tuple(x.shape)}")
    k = x.shape[0]
    for y, e in ((x, 0), *more):
        if y.dtype != torch.int64 or not y.is_contiguous():
            raise TypeError(f"{name}: expected contiguous int64 bit patterns, got "
                            f"{y.dtype}{'' if y.is_contiguous() else ', not contiguous'}")
        if y.shape != (k + e, *x.shape[1:]):
            raise ValueError(f"{name}: expected {(k + e, *x.shape[1:])} limbs, got "
                             f"{tuple(y.shape)}")
        if y.device != table.device:
            raise ValueError(f"{name}: limbs on {y.device}, table on {table.device}")
    if table.dtype != torch.int64 or table.dim() != 1:
        raise ValueError(f"{name}: expected a 1-D int64 table, got "
                         f"{tuple(table.shape)} {table.dtype}")
    return k


def _scratch(x: torch.Tensor, limbs: int):
    """Above MAX_K the kernels keep a column's limbs in device memory: (limbs,
    R, n) words beside x; none at or below it."""
    if x.shape[0] <= MAX_K:
        return None
    return torch.empty((limbs, *x.shape[1:]), dtype=torch.int64, device=x.device)


def behz_extend(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(k, R, n) canonical coefficients under q -> (k + 1, R, n) canonical
    under Bsk, by the kernel behz_extend (BehzCuda.extend_to_bsk on the
    card; `table` a BehzCuda's)."""
    k = _check_limbs("behz_extend", table, x)
    out = torch.empty((k + 1, *x.shape[1:]), dtype=torch.int64, device=x.device)
    _launch("behz_extend", x, table, table.numel(), out, _scratch(x, k), k,
            x[0].numel())
    return out


def behz_floor_sk(d_q: torch.Tensor, d_bsk: torch.Tensor,
                  table: torch.Tensor) -> torch.Tensor:
    """(k, R, n) and (k + 1, R, n) canonical tensor components under q and
    Bsk -> (k, R, n) canonical under q, by the kernel behz_floor_sk
    (BehzCuda.floor_sk on the card)."""
    k = _check_limbs("behz_floor_sk", table, d_q, (d_bsk, 1))
    out = torch.empty_like(d_q)
    _launch("behz_floor_sk", d_q, d_bsk, table, table.numel(), out,
            _scratch(d_q, 2 * k), k, d_q[0].numel())
    return out


class BehzCuda:
    """Device BEHZ multiply for one host BehzTool's parameters, on `device`
    ("cuda", the default, raises without a CUDA device; "cpu" runs every
    kernel's plain version).

    q_tabs supplies the level's forward-NTT roots (BfvContext.tabs[:k]) so the
    transforms reproduce the host tool's exactly; the Bsk roots come from
    tool.bsk_tables().  Every table, constant and precon is staged here and
    held by the object, so a captured graph of the composition reads only
    tensors that outlive it."""

    def __init__(self, tool: rns_behz.BehzTool,
                 q_tabs: Sequence[twiddles.NttTables], device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "BehzCuda(device='cuda'): no CUDA device is available; pass "
                    "device='cpu' to run the plain versions")
            if self.device.index is None:  # the card tensors report
                self.device = torch.device("cuda", torch.cuda.current_device())
        if not fits(tool):
            raise ValueError(
                f"no BEHZ multiply on the port's kernels at n = {tool.n} with "
                f"moduli of up to {max(tool.q + tool.Bsk).bit_length()} bits: "
                "n must be a power of two in [4, 32768] and every modulus of "
                "q u Bsk below 2^62; use the host BehzTool")
        if len(q_tabs) != tool.k:
            raise ValueError(f"expected {tool.k} q tables, got {len(q_tabs)}")
        T, dev = tool, self.device
        self.tool = T
        k, q, Bsk = T.k, T.q, T.Bsk
        self._q_tabs = [ntt_cuda.modulus_tables(T.n, m, int(tb.w), dev)
                        for m, tb in zip(q, q_tabs)]
        self._bsk_tabs = [ntt_cuda.modulus_tables(T.n, m, int(tb.w), dev)
                          for m, tb in zip(Bsk, T.bsk_tables())]
        self._runner = dyadic_cuda.runner(q + Bsk, dev)
        # extension q -> Bsk: x * m_tilde * q_hat_inv folded into one multiply
        self._ext_tilde = _Harvey.of(
            [(T.m_tilde % qi) * T.q_hat_inv[i] for i, qi in enumerate(q)], q, dev)
        self._q_to_bsk = _Conversion(T.q_hat_mod_Bsk.astype(object), Bsk, dev)
        self._qhat_mtilde = _col(T.q_hat_mod_mtilde, dev)
        self._q_mod_bsk = _Harvey.of(T.q_mod_Bsk.astype(object), Bsk, dev)
        self._inv_mtilde_bsk = _Harvey.of(T.inv_mtilde_mod_Bsk, Bsk, dev)
        # fast floor: the t-scaling under q folded into the conversion's
        # prologue; under Bsk t, then q^-1 after the subtraction
        self._floor_tilde = _Harvey.of(
            [T.t * T.q_hat_inv[i] for i in range(k)], q, dev)
        self._t_bsk = _Harvey.of([T.t] * (k + 1), Bsk, dev)
        self._inv_q_bsk = _Harvey.of(T.inv_q_mod_Bsk, Bsk, dev)
        self._bsk_col = _col(Bsk, dev)
        # Shenoy-Kumaresan: B -> q and B -> m_sk in one conversion
        self._sk_tilde = _Harvey.of(T.b_hat_inv, T.b, dev)
        self._b_to_q_msk = _Conversion(
            np.concatenate([T.b_hat_mod_q.astype(object),
                            T.b_hat_mod_msk.astype(object)[:, None]], axis=1),
            q + [T.m_sk], dev)
        self._inv_B_msk = _Harvey.of(T.inv_B_mod_msk, T.m_sk, dev)
        self._B_mod_q = _Harvey.of(T.B_mod_q.astype(object), q, dev)
        self._q_col = _col(q, dev)
        self.table = self._pack()
        self._programs = {}

    def _pack(self) -> torch.Tensor:
        """The kernels' constant table from the constants above, held by the
        object so that a captured graph reads it by pointer.  This list is its
        layout (the source's Layout states it again): moduli q, then Bsk =
        B u {m_sk}; a Harvey group of L constants, reduced mod their moduli,
        then their L precons; a (k, k + 1) matrix row-major.
        `table_slices` names each piece's words."""
        T = self.tool

        def harvey(h):
            return [h.c.flatten(), h.pre.flatten()]

        pieces = [
            ("q", [self._q_col.flatten()]), ("bsk", [self._bsk_col.flatten()]),
            ("ext_tilde", harvey(self._ext_tilde)),
            ("qhat_mtilde", [self._qhat_mtilde.flatten()]),
            ("neg_inv_q_mtilde", [_col([T.neg_inv_q_mod_mtilde], self.device).flatten()]),
            ("q_to_bsk", harvey(self._q_to_bsk.mul)), ("q_mod_bsk", harvey(self._q_mod_bsk)),
            ("inv_mtilde_bsk", harvey(self._inv_mtilde_bsk)),
            ("floor_tilde", harvey(self._floor_tilde)), ("t_bsk", harvey(self._t_bsk)),
            ("inv_q_bsk", harvey(self._inv_q_bsk)), ("sk_tilde", harvey(self._sk_tilde)),
            ("b_to_q_msk", harvey(self._b_to_q_msk.mul)),
            ("inv_B_msk", harvey(self._inv_B_msk)), ("B_mod_q", harvey(self._B_mod_q))]
        parts, self.table_slices, at = [], {}, 0
        for name, words in pieces:
            part = torch.cat(words)
            self.table_slices[name] = slice(at, at + part.numel())
            at += part.numel()
            parts.append(part)
        return torch.cat(parts)

    # -- the conversions: the kernels, or the plain versions (kernel_path) ----

    def extend_to_bsk(self, x: torch.Tensor) -> torch.Tensor:
        """(k, R, n) canonical coefficients under q -> (k+1, R, n) under Bsk
        (BehzTool.extend_to_bsk)."""
        if kernel_path(x.device):
            return behz_extend(x, self.table)
        return self._extend_to_bsk_plain(x)

    def floor_sk(self, d_q: torch.Tensor, d_bsk: torch.Tensor) -> torch.Tensor:
        """(k, R, n) and (k+1, R, n) canonical tensor components under q and
        Bsk -> (k, R, n) canonical under q: the fast floor of the t-scaled
        product, then Shenoy-Kumaresan back to q."""
        if kernel_path(d_q.device):
            return behz_floor_sk(d_q, d_bsk, self.table)
        return self._floor_sk_plain(d_q, d_bsk)

    # -- plain versions: lane math (BehzTool's primitives, every limb at once)

    def _extend_to_bsk_plain(self, x: torch.Tensor) -> torch.Tensor:
        """Plain version of extend_to_bsk."""
        T = self.tool
        xt = self._ext_tilde(x)
        conv = self._q_to_bsk(xt)
        r = (((xt & _M32) * self._qhat_mtilde) & _M32).sum(0) & _M32
        r = (r * T.neg_inv_q_mod_mtilde) & _M32
        neg = r >= (1 << 31)
        rmag = torch.where(neg, (1 << 32) - r, r)
        term = self._q_mod_bsk(rmag)
        m = self._bsk_col
        s = torch.where(neg, w.sub_mod(conv, term, m), w.add_mod(conv, term, m))
        return self._inv_mtilde_bsk(s)

    def _floor_sk_plain(self, d_q: torch.Tensor, d_bsk: torch.Tensor) -> torch.Tensor:
        """Plain version of floor_sk."""
        return self._fastbconv_sk(self._fast_floor(d_q, d_bsk))

    def _fast_floor(self, d_q: torch.Tensor, d_bsk: torch.Tensor) -> torch.Tensor:
        """(k, R, n) and (k+1, R, n) canonical tensor components under q and
        Bsk -> floor(t x / q) - alpha under Bsk (BehzTool.fast_floor of the
        t-scaled residues)."""
        f = self._q_to_bsk(self._floor_tilde(d_q))
        m = self._bsk_col
        return self._inv_q_bsk(w.sub_mod(self._t_bsk(d_bsk), f, m))

    def _fastbconv_sk(self, g: torch.Tensor) -> torch.Tensor:
        """(k+1, R, n) under Bsk -> (k, R, n) under q, exact
        (BehzTool.fastbconv_sk)."""
        T = self.tool
        k, msk = T.k, T.m_sk
        sums = self._b_to_q_msk(self._sk_tilde(g[:k]))  # (k+1, R, n)
        conv, h = sums[:k], sums[k]
        alpha = self._inv_B_msk(w.sub_mod(h, g[k], msk))
        neg = w.ge64(alpha, msk // 2 + 1)
        amag = torch.where(neg, msk - alpha, alpha)
        corr = self._B_mod_q(amag)
        q = self._q_col
        return torch.where(neg, w.add_mod(conv, corr, q), w.sub_mod(conv, corr, q))

    # -- the composition ------------------------------------------------------

    def _check(self, c1: torch.Tensor, c2: torch.Tensor) -> None:
        T = self.tool
        for x in (c1, c2):
            if x.dtype != torch.int64 or x.device != self.device:
                raise TypeError(f"expected int64 tensors on {self.device}, got "
                                f"{x.dtype} on {x.device}")
        if c1.dim() != 4 or c1.shape[1:] != (2, T.k, T.n) or c1.shape != c2.shape:
            raise ValueError(f"expected two (B, 2, {T.k}, {T.n}) ciphertext "
                             f"batches, got {tuple(c1.shape)} and {tuple(c2.shape)}")

    def multiply_tensors(self, c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
        """(B, 2, k, n) canonical NTT-limb ciphertexts (int64 patterns) ->
        (B, 3, k, n) canonical NTT-limb tensor output scaled by t/q, launched
        one by one (an eager body)."""
        _count("eager")
        return self._compose(c1, c2)

    def _compose(self, c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
        """multiply_tensors' composition, uncounted: what a program captures."""
        self._check(c1, c2)
        T = self.tool
        k, n, B = T.k, T.n, c1.shape[0]
        pair = torch.stack([c1, c2])                       # (2, B, 2, k, n)
        # 1. coefficients of the four polynomials, (4B, n) rows per q limb
        rows = pair.permute(3, 0, 2, 1, 4).contiguous()    # (k, 2, 2, B, n)
        coeff = torch.stack([ntt_cuda.ntt_inv(rows[i].view(4 * B, n), self._q_tabs[i])
                             for i in range(k)])
        # 2.-3. extend to Bsk, forward under each Bsk modulus
        ext = self.extend_to_bsk(coeff)                    # (k+1, 4B, n)
        bsk = torch.stack([ntt_cuda.ntt_fwd(ext[d], self._bsk_tabs[d])
                           for d in range(k + 1)])
        # 4. the tensor product over q u Bsk in one launch
        ops = torch.cat([pair, bsk.view(k + 1, 2, 2, B, n).permute(1, 3, 2, 0, 4)],
                        dim=3)                             # (2, B, 2, 2k+1, n)
        d = self._runner.run(ops[0], ops[1])               # (B, 3, 2k+1, n)
        # 5. the three components back to coefficients, (3B, n) rows
        comp = d.permute(2, 1, 0, 3).contiguous()          # (2k+1, 3, B, n)
        d_q = torch.stack([ntt_cuda.ntt_inv(comp[i].view(3 * B, n), self._q_tabs[i])
                           for i in range(k)])
        d_bsk = torch.stack([ntt_cuda.ntt_inv(comp[k + j].view(3 * B, n), self._bsk_tabs[j])
                             for j in range(k + 1)])
        # 6. fast floor, exact Shenoy-Kumaresan back to q
        res = self.floor_sk(d_q, d_bsk)                    # (k, 3B, n)
        # 7. back to the NTT domain under q
        out = torch.stack([ntt_cuda.ntt_fwd(res[i], self._q_tabs[i]) for i in range(k)])
        return out.view(k, 3, B, n).permute(2, 1, 0, 3).contiguous()

    def program(self, B: int) -> "_CountedProgram":
        """The multiply of B ciphertext pairs as a GraphProgram, cached per B:
        on the card one captured CUDA graph, replayed with the eager
        composition's bits."""
        if B not in self._programs:
            T = self.tool
            ex = torch.zeros((B, 2, T.k, T.n), dtype=torch.int64, device=self.device)
            self._programs[B] = _CountedProgram(GraphProgram(self._compose, ex, ex))
        return self._programs[B]

    # -- host conveniences ----------------------------------------------------

    def multiply_batch(self, ct1_ntt: np.ndarray, ct2_ntt: np.ndarray) -> np.ndarray:
        """(B, 2, k, n) u64 NTT-limb ciphertexts -> (B, 3, k, n) u64, equal to
        BehzTool.multiply per batch row."""
        c1 = w.from_u64_np(ct1_ntt, self.device)
        c2 = w.from_u64_np(ct2_ntt, self.device)
        self._check(c1, c2)
        return w.to_u64_np(self.program(c1.shape[0])(c1, c2))

    def multiply(self, ct1_ntt: np.ndarray, ct2_ntt: np.ndarray) -> np.ndarray:
        """(2, k, n) -> (3, k, n): the BehzTool.multiply drop-in."""
        return self.multiply_batch(np.asarray(ct1_ntt)[None],
                                   np.asarray(ct2_ntt)[None])[0]


class _CountedProgram:
    """A BEHZ GraphProgram whose calls `GRAPHS` counts: a replay where it
    holds a captured graph, else an eager body.  `graph` is the program's."""

    def __init__(self, program: GraphProgram):
        self.program = program
        if program.graph is not None:
            _count("captures")

    @property
    def graph(self):
        return self.program.graph

    def __call__(self, c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
        _count("eager" if self.program.graph is None else "replays")
        return self.program(c1, c2)
