"""The split inverse kernel's schedule on the CPU: a row held as C strided
pieces (C = 1, 2, 4; piece c = the values at c, c + C, ...), the stages that
cross them first, then each piece alone under the row's twiddles
(`ntt_cuda._inv_split_plain`, mirroring `inv_cross` / `inv_split` of
csrc/ntt_kernels.cuh), against the reference's golden model and, at
n = 1024, the Pallas kernel it replaces (interpret mode, tile_p=2); and the
choice of C for the inverse (`ntt_cuda.row_split(..., kernel="ntt_inv")`).

Tolerance: zero."""

import functools

import jax
import numpy as np
import pytest
import torch

from hexl_fpga_tpu.ops import golden as ref_golden, ntt_mxu_pallas, word64 as jw
from hexl_fpga_tpu_torch import convert
from hexl_fpga_tpu_torch.ops import nt, ntt_cuda, word64 as w

SIZES = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 16384)
PALLAS_N = 1024
TILE_P = 2


@functools.lru_cache(maxsize=None)
def case(n: int, in_bits: int):
    """(q, input rows, golden inverse of the rows mod q) for n, from a seed;
    two rows at 16384, else four (a whole number of Pallas tiles)."""
    bits = 61 if n % 3 == 2 else (30 if n in (16, 256) else 50)
    q = int(nt.generate_primes(1, bits, n)[0])
    rng = np.random.default_rng(3 * n + in_bits)
    a = rng.integers(0, 1 << in_bits, size=(2 if n == 16384 else 4, n), dtype=np.uint64)
    a[0, :2] = [q - 1, (1 << in_bits) - 1]
    return q, a, ref_golden.inv_ntt(a % np.uint64(q), q)


def port(fn, a, *args, **kw):
    return w.to_u64_np(fn(w.from_u64_np(a), *args, **kw))


SPLIT_CASES = [(n, parts, bits) for n in SIZES for parts in (1, 2, 4)
               for bits in (53, 64) if 2 * parts <= n]


@pytest.mark.parametrize("n,parts,in_bits", SPLIT_CASES)
def test_inverse_split_schedule_equals_golden(n, parts, in_bits):
    q, a, want = case(n, in_bits)
    tabs = ntt_cuda.modulus_tables(n, q, device="cpu")
    np.testing.assert_array_equal(
        port(ntt_cuda.ntt_inv_plain, a, tabs, parts=parts), want)


@functools.lru_cache(maxsize=None)
def pallas_case():
    q, a, _ = case(PALLAS_N, 53)
    red = a % np.uint64(q)
    call = ntt_mxu_pallas.raw_inv_call(PALLAS_N, q, TILE_P, interpret=True)
    olo, ohi = jax.jit(call)(*jw.to_pair_np(red))
    return q, red, w.to_u64_np(convert.pair_to_i64(olo, ohi))


@pytest.mark.parametrize("parts", (1, 2, 4))
def test_inverse_split_schedule_equals_pallas_inverse(parts):
    q, red, ref = pallas_case()
    tabs = ntt_cuda.modulus_tables(PALLAS_N, q, device="cpu")
    np.testing.assert_array_equal(
        port(ntt_cuda.ntt_inv_plain, red, tabs, parts=parts), ref)


@pytest.mark.parametrize("n,parts", [(n, p) for n in (8, 2048) for p in (1, 2, 4)])
def test_cpu_tensor_under_a_forced_split_takes_the_plain_version(n, parts):
    q, a, want = case(n, 64)
    tabs = ntt_cuda.modulus_tables(n, q, device="cpu")
    ntt_cuda.reset_launch_counts()
    np.testing.assert_array_equal(port(ntt_cuda.ntt_inv, a, tabs, parts), want)
    assert ntt_cuda.LAUNCHES["ntt_inv"] == 0


def test_round_trip_under_every_split():
    """ntt_inv_plain undoes ntt_fwd_plain whatever split either takes."""
    q, a, _ = case(2048, 53)
    red = a % np.uint64(q)
    tabs = ntt_cuda.modulus_tables(2048, q, device="cpu")
    for fwd_parts in (1, 2, 4):
        f = ntt_cuda.ntt_fwd_plain(w.from_u64_np(red), tabs, fwd_parts)
        for inv_parts in (1, 2, 4):
            np.testing.assert_array_equal(
                w.to_u64_np(ntt_cuda.ntt_inv_plain(f, tabs, inv_parts)), red)


def test_inverse_row_split_at_the_paths_shapes():
    """KeySwitch's INTT1 (32 rows) takes four strided pieces a row, INTT2
    (64 rows) two, _INTT's 256 rows one: the most that fill one wave of the
    model's one block an SM, else the fewest waves per unit of row."""
    assert [ntt_cuda.row_split(rows, 16384, kernel="ntt_inv")
            for rows in (32, 64, 256)] == [4, 2, 1]
    for rows in (1, 5, 32, 64, 192, 256, 1024):
        for n in SIZES:
            parts = ntt_cuda.row_split(rows, n, kernel="ntt_inv")
            assert parts in ntt_cuda.split_candidates(n, "ntt_inv"), (rows, n)
    assert ntt_cuda.split_blocks_per_sm(16384, 4, "ntt_inv") == 1


def test_forced_inverse_split_is_checked():
    """A caller's parts must be 1, 2 or 4, at most n/2, and give a piece that
    fits one block's shared memory: at n = 32768 2 or 4, not 1."""
    q = int(nt.generate_primes(1, 61, 32768)[0])
    x = torch.zeros(1, 32768, dtype=torch.int64)
    tabs = ntt_cuda.modulus_tables(32768, q, device="cpu")
    with pytest.raises(ValueError, match="a piece of 32768 values takes 278520 bytes"):
        ntt_cuda.ntt_inv(x, tabs, 1)
    assert torch.equal(ntt_cuda.ntt_inv(x, tabs, 2), x)  # INTT(0) = 0
    with pytest.raises(ValueError, match="parts"):
        ntt_cuda.ntt_inv(torch.zeros(1, 4, dtype=torch.int64),
                         ntt_cuda.modulus_tables(4, 17, device="cpu"), 4)
