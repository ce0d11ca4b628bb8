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
  * base extension / SmMRq /
    fast floor / Shenoy-Kumaresan -> torch ops: every constant multiply is a
                                   Harvey lazy multiply against a precon
                                   computed here (exact in [0, 2m) for any u64
                                   operand), and each fast base conversion is
                                   ONE lazy multiply of the (k, R, n) limbs by
                                   a (k, D, 1, 1) constant tensor, summed over
                                   the source limbs and reduced once;
  * m_tilde = 2^32 arithmetic    -> int64 ops on the low 32 bits, masked after
                                   every product and sum (wrapping int64
                                   multiplication agrees with uint32 there).

Every step ends canonical, as in the host tool and the reference's device
module, so the three give the same bits.  The port serves any n of its
transform kernels and every modulus below 2^62 (the reference's MXU plan
stops at 2^55): a lazy conversion sum is reduced before it could reach 2^64.

`BehzCuda.multiply_tensors` is the composition (the reference's
`_multiply_pairs`); `program(B)` replays it as one captured CUDA graph on the
card (the reference jits it into one program), and `multiply_batch` /
`multiply` take and give u64 numpy arrays through it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from . import dyadic_cuda, ntt_cuda, rns_behz, twiddles, word64 as w
from ..utils.graph import GraphProgram

_M32 = 0xFFFFFFFF


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
        self._programs = {}

    # -- lane math (rns_behz.BehzTool's primitives, every limb at once) -------

    def _extend_to_bsk(self, x: torch.Tensor) -> torch.Tensor:
        """(k, R, n) canonical coefficients under q -> (k+1, R, n) under Bsk
        (BehzTool.extend_to_bsk)."""
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
        (B, 3, k, n) canonical NTT-limb tensor output scaled by t/q."""
        self._check(c1, c2)
        T = self.tool
        k, n, B = T.k, T.n, c1.shape[0]
        pair = torch.stack([c1, c2])                       # (2, B, 2, k, n)
        # 1. coefficients of the four polynomials, (4B, n) rows per q limb
        rows = pair.permute(3, 0, 2, 1, 4).contiguous()    # (k, 2, 2, B, n)
        coeff = torch.stack([ntt_cuda.ntt_inv(rows[i].view(4 * B, n), self._q_tabs[i])
                             for i in range(k)])
        # 2.-3. extend to Bsk, forward under each Bsk modulus
        ext = self._extend_to_bsk(coeff)                   # (k+1, 4B, n)
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
        res = self._fastbconv_sk(self._fast_floor(d_q, d_bsk))  # (k, 3B, n)
        # 7. back to the NTT domain under q
        out = torch.stack([ntt_cuda.ntt_fwd(res[i], self._q_tabs[i]) for i in range(k)])
        return out.view(k, 3, B, n).permute(2, 1, 0, 3).contiguous()

    def program(self, B: int) -> GraphProgram:
        """The multiply of B ciphertext pairs as a GraphProgram, cached per B:
        on the card one captured CUDA graph, replayed with the eager
        composition's bits."""
        if B not in self._programs:
            T = self.tool
            ex = torch.zeros((B, 2, T.k, T.n), dtype=torch.int64, device=self.device)
            self._programs[B] = GraphProgram(self.multiply_tensors, ex, ex)
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
