"""The split forward kernels' schedule on the CPU: a row held as C pieces
(C = 1, 2, 4), the stages that cross them first, then each piece alone with
offset twiddles (`ntt_cuda._fwd_split_plain`, mirroring `fwd_cross` /
`fwd_split` of csrc/ntt_kernels.cuh), against the reference's golden model
and, at n = 1024, the Pallas kernel it replaces (interpret mode, tile_p=2);
and the choice of C (`ntt_cuda.row_split`).

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
    """(q, input rows, golden output) for n, from a seed; two rows at 16384, else four
    (a whole number of Pallas tiles)."""
    bits = 61 if n % 3 == 2 else (30 if n in (16, 256) else 50)
    q = int(nt.generate_primes(1, bits, n)[0])
    rng = np.random.default_rng(n + in_bits)
    a = rng.integers(0, 1 << in_bits, size=(2 if n == 16384 else 4, n), dtype=np.uint64)
    a[0, :2] = [q - 1, (1 << in_bits) - 1]
    return q, a, ref_golden.fwd_ntt(a % np.uint64(q), q)


def port(fn, a, *args, **kw):
    return w.to_u64_np(fn(w.from_u64_np(a), *args, **kw))


SPLIT_CASES = [(n, parts, bits) for n in SIZES for parts in (1, 2, 4)
               for bits in (53, 64) if 2 * parts <= n]


@pytest.mark.parametrize("n,parts,in_bits", SPLIT_CASES)
def test_split_schedule_equals_golden(n, parts, in_bits):
    q, a, want = case(n, in_bits)
    tabs = ntt_cuda.modulus_tables(n, q, device="cpu")
    np.testing.assert_array_equal(
        port(ntt_cuda.ntt_fwd_plain, a, tabs, parts=parts), want)
    # a CPU tensor takes the plain version under any forced split
    np.testing.assert_array_equal(port(ntt_cuda.ntt_fwd, a, tabs, parts), want)


@functools.lru_cache(maxsize=None)
def pallas_case():
    q, a, _ = case(PALLAS_N, 53)
    red = a % np.uint64(q)
    planes = [p for p in jw.to_pair_np(red)]
    call = ntt_mxu_pallas.raw_fwd_call(PALLAS_N, q, TILE_P, interpret=True)
    olo, ohi = jax.jit(call)(*planes)
    return q, red, w.to_u64_np(convert.pair_to_i64(olo, ohi))


@pytest.mark.parametrize("parts", (1, 2, 4))
def test_split_schedule_equals_pallas_forward(parts):
    q, red, ref = pallas_case()
    tabs = ntt_cuda.modulus_tables(PALLAS_N, q, device="cpu")
    np.testing.assert_array_equal(
        port(ntt_cuda.ntt_fwd_plain, red, tabs, parts=parts), ref)


@pytest.mark.parametrize("n,parts", [(n, p) for n in (8, 64, 2048) for p in (2, 4)])
def test_tail_split_equals_whole_row(n, parts):
    q, e, _ = case(n, 64)
    rng = np.random.default_rng(n * parts)
    acc = rng.integers(0, 1 << 64, size=e.shape, dtype=np.uint64)
    res = rng.integers(0, q, size=e.shape, dtype=np.uint64)
    msf = int(rng.integers(1, q))
    args = [w.from_u64_np(x) for x in (e, acc, res)]
    args += [ntt_cuda.modulus_tables(n, q, device="cpu"), q - 12345, msf, (msf << 64) // q]
    whole = ntt_cuda.ntt_fwd_tail_plain(*args, parts=1)
    assert torch.equal(ntt_cuda.ntt_fwd_tail_plain(*args, parts=parts), whole)
    assert torch.equal(ntt_cuda.ntt_fwd_tail(*args, parts=parts), whole)


def slots(n, parts):
    return ntt_cuda.H100_SM_COUNT * ntt_cuda.split_blocks_per_sm(n, parts)


@pytest.mark.parametrize("rows", (1, 5, 32, 64, 192, 256, 1024))
def test_row_split_fills_one_wave_where_it_can(rows):
    for n in SIZES:
        parts = ntt_cuda.row_split(rows, n)
        assert parts in ntt_cuda.split_candidates(n), (rows, n)
        assert 2 * parts <= n
        assert ntt_cuda.row_split(rows, n, "cpu") == parts
        fits = [p for p in ntt_cuda.split_candidates(n) if rows * p <= slots(n, p)]
        if fits:
            assert rows * parts <= slots(n, parts), (rows, n, parts)


def test_row_split_at_the_paths_shapes():
    """KeySwitch's 192 rows and its tail's 64 take two blocks a row (three
    and one wave of half rows at one block an SM); _NTT's 256 rows take one;
    32 rows take four; a row below 8192 values is never split."""
    assert [ntt_cuda.row_split(rows, 16384)
            for rows in (192, 64, 256, 32)] == [2, 2, 1, 4]
    assert ntt_cuda.split_candidates(4096) == [1]
    assert ntt_cuda.split_blocks_per_sm(16384, 1) == 1  # 128 KB: one an SM
    with pytest.raises(ValueError, match="parts"):
        ntt_cuda.ntt_fwd_plain(torch.zeros(1, 4, dtype=torch.int64),
                               ntt_cuda.modulus_tables(4, 17, device="cpu"), parts=4)


def test_forced_split_is_checked():
    """A caller's parts must be 1, 2 or 4, at most n/2, and give a piece that
    fits one block's shared memory: at n = 32768 2 or 4, not 1."""
    x = torch.zeros(1, 32768, dtype=torch.int64)
    tabs = ntt_cuda.modulus_tables(32768, int(nt.generate_primes(1, 61, 32768)[0]), device="cpu")
    with pytest.raises(ValueError, match="a piece of 32768 values takes 278520 bytes"):
        ntt_cuda.ntt_fwd(x, tabs, 1)
    assert torch.equal(ntt_cuda.ntt_fwd(x, tabs, 4), x)  # NTT(0) = 0
    with pytest.raises(ValueError, match="parts"):
        ntt_cuda.ntt_fwd(torch.zeros(1, 64, dtype=torch.int64),
                         ntt_cuda.modulus_tables(64, 257, device="cpu"), 3)


@pytest.mark.parametrize("rows", (1, 32, 256))
def test_row_split_at_n_32768(rows):
    """A row of 32768 values takes 2 or 4 blocks, never one, in both
    directions; the _NTT path's 32 rows take 4 (128 blocks: one wave of the
    model's one block an SM), 256 rows 2."""
    assert ntt_cuda.split_candidates(32768) == [2, 4]
    assert ntt_cuda.split_candidates(32768, "ntt_inv") == [2, 4]
    want = {1: 4, 32: 4, 256: 2}[rows]
    for kernel in ("ntt_fwd", "ntt_inv", "ntt_fwd_tail"):
        assert ntt_cuda.row_split(rows, 32768, kernel=kernel) == want, kernel


@pytest.mark.parametrize("kernel", ("ntt_fwd", "ntt_inv", "ntt_fwd_tail"))
def test_one_block_a_row_refused_at_n_32768(kernel):
    """A forced C = 1 at n = 32768 is refused with the piece's size, on any
    device, before any kernel or plain version runs."""
    q = int(nt.generate_primes(1, 61, 32768)[0])
    tabs = ntt_cuda.modulus_tables(32768, q, device="cpu")
    x = torch.zeros(2, 32768, dtype=torch.int64)
    call = {"ntt_fwd": lambda: ntt_cuda.ntt_fwd(x, tabs, 1),
            "ntt_inv": lambda: ntt_cuda.ntt_inv(x, tabs, 1),
            "ntt_fwd_tail": lambda: ntt_cuda.ntt_fwd_tail(x, x, x, tabs, 0, 1, 1, 1)}
    with pytest.raises(ValueError, match=r"parts = 1 at n = 32768: a piece of "
                                         r"32768 values takes 278520 bytes, more "
                                         r"than one block's 232448 bytes"):
        call[kernel]()
