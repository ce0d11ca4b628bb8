"""KeySwitch: its inputs from the seed, the port's two entries, the reference.

Inputs (a pool of distinct ops, drawn on the device in one call per
modulus): targets t (P, L*n) and accumulators r (P, comp*L*n) below each
limb's modulus, the switching keys (L arrays of comp*K*n words), the
modswitch factors q_k^-1 mod q_i worked out from the moduli, and no twiddle
table: each side derives the least primitive 2n-th root of each modulus.

API entry: `KeySwitch(result, t, ...)` accumulates into `result` in place:
each slot's buffer starts as its pristine accumulator r0 and takes every op
of that slot, so after k ops it holds r0 + k * delta (mod each limb's
modulus), delta being one op's contribution.  The check works that out from
the reference's one-op answer, so a kept buffer vouches for every earlier op
of its slot too.  Device entry: `KeySwitchContext.dispatch_batch` on
handles staged once in set-up; its results stay on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from hebench.driver import batch_rows
from hebench.reference import keyswitch as ref_keyswitch
from hebench.reference import primes

BATCH_ENV = "BATCH_SIZE_KEYSWITCH"
DIGIT = 11  # bits of a count taken a step: q * 2^DIGIT < 2^63 for q < 2^52


def _u64(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy().view(np.uint64)


def times(k: np.ndarray, x: np.ndarray, q: np.ndarray) -> np.ndarray:
    """k * x mod q, exact, for x in [0, q), q < 2^52 and any u64 counts k
    (one a row, shape (rows, 1)): Horner over DIGIT-bit digits of k, so
    each step's sum stays below 2^64."""
    acc = np.zeros_like(x)
    bits = int(k.max(initial=0)).bit_length()
    for s in range((max(bits, 1) - 1) // DIGIT * DIGIT, -1, -DIGIT):
        digit = (k >> np.uint64(s)) & np.uint64((1 << DIGIT) - 1)
        acc = (acc * np.uint64(1 << DIGIT) + digit * x) % q
    return acc


class Workload:
    def __init__(self, cfg: dict, pool: int, seed: int, device):
        self.cfg = cfg
        self.n, self.L, self.K = (cfg["n"], cfg["decomp_modulus_size"],
                                  cfg["key_modulus_size"])
        self.comp = cfg["key_component_count"]
        self.moduli = [int(q) for q in cfg["moduli"]]
        n, L, K, comp = self.n, self.L, self.K, self.comp
        qk = self.moduli[K - 1]
        self.msf = [pow(qk, -1, q) for q in self.moduli[:K - 1]] + [0]
        gen = torch.Generator(device=device).manual_seed(seed)
        draw = lambda q, shape: torch.randint(0, q, shape, generator=gen,
                                              device=device, dtype=torch.int64)
        t = torch.empty((pool, L, n), dtype=torch.int64, device=device)
        r = torch.empty((pool, comp, L, n), dtype=torch.int64, device=device)
        for j in range(L):
            x = draw(self.moduli[j], (pool, 1 + comp, n))
            t[:, j], r[:, :, j] = x[:, 0], x[:, 1:]
        keys = torch.empty((L, comp, K, n), dtype=torch.int64, device=device)
        for j in range(K):
            keys[:, :, j] = draw(self.moduli[j], (L, comp, n))
        self.t = _u64(t).reshape(pool, L * n)
        self.pristine = _u64(r).reshape(pool, comp * L * n)
        keys = _u64(keys)
        self.keys = [np.ascontiguousarray(keys[i]).reshape(-1) for i in range(L)]
        self.results = self.pristine.copy()
        self.uses = np.zeros(pool, dtype=np.int64)  # ops queued on each slot
        # each word's modulus, in the (comp, L, n) layout of a result
        if max(self.moduli) >= 1 << 52:
            raise ValueError("the check's count product needs moduli below 2^52")
        self.q_words = np.repeat(np.tile(np.array(self.moduli[:L], np.uint64),
                                         comp), n)
        self.pool = pool

    # -- the API entry -----------------------------------------------------

    def api(self):
        import hexl_fpga_tpu_torch as hexl

        self.hexl = hexl
        hexl.acquire_FPGA_resources()

    def set_worksize(self, ws: int) -> None:
        self.hexl.set_worksize_KeySwitch(ws)

    def restore(self, slot: int, sampled: bool) -> None:
        """Nothing: the slot's buffer accumulates (see the module's doc)."""

    def call(self, slot: int) -> None:
        self.uses[slot] += 1
        self.hexl.KeySwitch(self.results[slot], self.t[slot], self.n, self.L,
                            self.K, self.cfg["rns_modulus_size"], self.comp,
                            self.moduli, self.keys, self.msf, None)

    def completed(self) -> None:
        self.hexl.KeySwitchCompleted()

    def result(self, slot: int):
        """The slot's buffer and the count of ops it has taken."""
        return self.results[slot].copy(), int(self.uses[slot])

    def after(self, rows, once: np.ndarray, uses) -> np.ndarray:
        """The answers of `rows` after `uses` ops each, from `once`, their
        one-op answers: r0 + uses * (once - r0) mod q, word by word."""
        q = self.q_words
        r0 = self.pristine[rows]
        delta = (once + q - r0) % q
        k = np.asarray(uses, dtype=np.uint64)[:, None]
        return (r0 + times(k, delta, q)) % q

    def release(self) -> None:
        self.hexl.release_FPGA_resources()

    # -- the device entry --------------------------------------------------

    def device(self, batch: int, batches: int, device):
        from hexl_fpga_tpu_torch.ops import keyswitch_cuda

        self.ctx = keyswitch_cuda.KeySwitchContext(
            self.n, self.L, self.K, self.cfg["rns_modulus_size"], self.comp,
            self.moduli, None, device=device)
        self.staged = []
        for b in range(batches):
            rows = batch_rows(b, batch, self.pool)
            self.staged.append((self.ctx.stage_ciphertext(self.pristine[rows]),
                                self.ctx.stage_target(self.t[rows]), rows))

    def dispatch(self, b: int) -> torch.Tensor:
        ct, target, _ = self.staged[b]
        return self.ctx.dispatch_batch(ct, target, self.keys, self.msf)

    def device_rows(self, b: int) -> list:
        return self.staged[b][2]

    def device_result(self, out: torch.Tensor):
        """A batch's results (one op each: the staged inputs stay as they
        were)."""
        return _u64(out).reshape(out.shape[0], -1), 1

    def release_device(self) -> None:
        self.ctx = self.staged = None

    # -- the plain reference -----------------------------------------------

    def reference(self, mode: str, device):
        """rows -> the (len(rows), comp*L*n) u64 results of those pool rows."""
        n, L, K = self.n, self.L, self.K
        psis = [primes.minimal_root(n, q) for q in self.moduli]
        keys = torch.from_numpy(np.stack(self.keys).view(np.int64))
        ks = ref_keyswitch.KeySwitch(n, L, K, self.moduli, psis, self.msf,
                                     keys.view(L, self.comp, K, n), mode, device)

        def run(rows):
            t = torch.from_numpy(self.t[rows].view(np.int64)).to(device)
            r = torch.from_numpy(self.pristine[rows].view(np.int64)).to(device)
            out = ks(t.view(-1, L, n), r.view(-1, self.comp, L, n))
            return _u64(out).reshape(len(rows), -1)

        return run
