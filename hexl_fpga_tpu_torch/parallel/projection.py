"""A scaling model for the sharded paths, fed with measured single-card times.

The counterpart of `hexl_fpga_tpu/parallel/projection.py`: the same three
models with the same formulas, and the same slot layout as
`ShardedKeySwitch`.  It is a MODEL, not a measurement: the repository's card
box holds one H100, so no run of this port has crossed a link between two
cards, and nothing here says how it would scale.  Every input is an
argument: the single-card times, the transform share `alpha`, the link's
bytes per second and the fixed cost of one collective.  None has a default
taken from the reference's accelerator.

Model (RNS-limb sharding 'mp', one KeySwitch over P cards in lockstep):

    T_P = T1 * ( alpha * R_P / R_1  +  (1 - alpha) * E_P / E_1 )  +  T_comm(P)

* T1         the single-card time per batch;
* alpha      the transforms' share of T1 (the NTT kernels' share of the
             body's busy time on the card);
* R_1, R_P   transform rows: R_1 = L + (L+1)L + c + cL (INTT1, engine
             transforms, INTT2, tails); the busiest rank at P replicates
             INTT1 and owns ceil((L+1)/P) engines;
* E_1, E_P   MAC terms, by engine count: L + 1 and the engines owned;
* T_comm(P)  the e psum (an all-reduce, 2X(P-1)/P bytes a card) and the
             output gather (X(P-1)/P) at the link's rate, plus a fixed cost
             per collective.

Efficiency(P) = T1 / (P * T_P).  Batch sharding ('dp') has no collective.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVLink 4 of an H100 SXM: 900 GB/s to the other cards of the host, all to
# all, 450 GB/s each way (NVIDIA H100 data sheet).  The card the port runs
# on is an NVIDIA H100 80GB HBM3 at a 700.00 W power limit; this rate has
# never been measured here (one card, no link).
NVLINK4_BYTES_PER_S_PER_DIRECTION = 450e9


@dataclass
class MpProjection:
    chips: int
    t1_ms: float          # the single-card ms per batch it was fed
    t_p_ms: float         # modelled ms per batch on the busiest card
    compute_ms: float
    comm_ms: float
    speedup: float        # T1 / T_P
    efficiency: float     # T1 / (P * T_P)


def _slots(P: int, L: int):
    """Owned engines per rank, ShardedKeySwitch's layout: engines 0..L-1 and
    the special one (index L here), padded to a multiple of P."""
    engines = list(range(L)) + [L]
    while len(engines) % P:
        engines.append(-1)
    per = len(engines) // P
    return [[e for e in engines[p * per:(p + 1) * per] if e >= 0] for p in range(P)]


def _comm_ms(P, batch, n, comp, L, link_bytes_per_s, collective_ms):
    plane = batch * comp * n * 8  # a (batch, comp, n) plane of u64
    ring = (P - 1) / P if P > 1 else 0.0
    s = (2 * plane * ring + L * plane * ring) / link_bytes_per_s
    return s * 1e3 + (2 * collective_ms if P > 1 else 0.0)


def _projection(P, t1_ms, compute_ms, comm_ms, digits=3):
    t_p = compute_ms + comm_ms
    return MpProjection(
        chips=P, t1_ms=t1_ms, t_p_ms=round(t_p, digits),
        compute_ms=round(compute_ms, digits), comm_ms=round(comm_ms, digits),
        speedup=round(t1_ms / t_p, 2), efficiency=round(t1_ms / (P * t_p), 3),
    )


def keyswitch_mp_projection(P: int, t1_ms: float, batch: int, alpha: float,
                            link_bytes_per_s: float, collective_ms: float,
                            n: int = 16384, L: int = 6,
                            comp: int = 2) -> MpProjection:
    """The limb-sharded KeySwitch on P cards from the single-card t1_ms per
    batch (see the module docstring)."""
    assert P >= 1
    K_eng = L + 1
    R1 = L + K_eng * L + comp + comp * L
    worst_rows, worst_eng = 0, 0
    for owned in _slots(P, L):
        rows = L + len(owned) * (L + comp)
        if rows > worst_rows:
            worst_rows, worst_eng = rows, len(owned)
    compute_ms = t1_ms * (alpha * worst_rows / R1
                          + (1 - alpha) * worst_eng / K_eng)
    comm_ms = _comm_ms(P, batch, n, comp, L, link_bytes_per_s, collective_ms)
    return _projection(P, t1_ms, compute_ms, comm_ms)


def keyswitch_hoisted_mp_projection(P: int, t1_ms: float, t1h_ms: float,
                                    batch: int, alpha: float,
                                    link_bytes_per_s: float,
                                    collective_ms: float, n: int = 16384,
                                    L: int = 6, comp: int = 2) -> MpProjection:
    """The sharded hoisted apply (`hoist` / `run_hoisted`) on P cards:
    t1_ms, the single-card full KeySwitch per batch, prices a transform row
    (t1_ms * alpha / R_1); t1h_ms is the single-card hoisted apply per
    batch, whose remainder after its transform rows (INTT2 and the tails)
    scales with the engines owned."""
    assert P >= 1
    K_eng = L + 1
    R1 = L + K_eng * L + comp + comp * L
    R1h = comp + comp * L
    row_ms = t1_ms * alpha / R1
    resid_1 = t1h_ms - row_ms * R1h
    worst = 0.0
    for owned in _slots(P, L):
        t = row_ms * comp * len(owned) + resid_1 * len(owned) / K_eng
        worst = max(worst, t)
    comm_ms = _comm_ms(P, batch, n, comp, L, link_bytes_per_s, collective_ms)
    return _projection(P, t1h_ms, worst, comm_ms)


def dist_ntt_sp_projection(P: int, t1_ms: float, batch: int,
                           link_bytes_per_s: float, collective_ms: float,
                           n: int = 16384, chunks: int = 4,
                           bytes_per_coeff: float = 16) -> MpProjection:
    """The coefficient-sharded transform on P cards: compute t1_ms / P, the
    exchange batch * n * bytes_per_coeff * (P-1)/P bytes at the link's rate,
    and `chunks` pipelined slices of the batch exposing only 1/chunks of the
    smaller of the two: T = max(A, B) + min(A, B) / C + C * collective_ms.
    The reference's four-step moves 16 bytes a coefficient; the port's
    binary exchange moves log2(P) blocks of 8 bytes a coefficient from
    each rank, in turn (chunks = 1)."""
    compute_ms = t1_ms / P
    ring = (P - 1) / P if P > 1 else 0.0
    comm_ms = batch * n * bytes_per_coeff * ring / link_bytes_per_s * 1e3
    C = max(1, int(chunks))
    if P > 1:
        t_p = (max(compute_ms, comm_ms) + min(compute_ms, comm_ms) / C
               + collective_ms * C)
    else:
        t_p = compute_ms
    return MpProjection(
        chips=P, t1_ms=t1_ms, t_p_ms=round(t_p, 4),
        compute_ms=round(compute_ms, 4), comm_ms=round(comm_ms, 4),
        speedup=round(t1_ms / t_p, 2), efficiency=round(t1_ms / (P * t_p), 3),
    )


def binary_exchange_bytes_per_coeff(P: int) -> float:
    """dist_ntt_sp_projection's bytes_per_coeff for the port's exchange:
    each of log2(P) stages sends every rank's n/P u64 values once, which
    the model's (P-1)/P ring factor then scales."""
    return 0.0 if P < 2 else 8 * (P.bit_length() - 1) / (P - 1)


def report(t1_ks_ms: float, t1_hoisted_ms: float, t1_ntt_ms: float,
           alpha: float, collective_ms: float, ks_batch: int = 32,
           ntt_batch: int = 32,
           link_bytes_per_s: float = NVLINK4_BYTES_PER_S_PER_DIRECTION,
           device: str = "") -> str:
    """The model's block for a log, from measured single-card times:
    t1_ks_ms the KeySwitch body per batch of ks_batch, t1_hoisted_ms the
    hoisted apply per batch, t1_ntt_ms one forward transform of ntt_batch
    rows, alpha the transforms' share of the body, collective_ms one
    collective's measured fixed cost."""
    lines = [
        f"scaling MODEL, not a measurement (parallel/projection.py; inputs "
        f"measured on one card{', ' + device if device else ''}; link "
        f"{link_bytes_per_s / 1e9:.0f} GB/s each way, the H100 SXM data "
        f"sheet's NVLink 4, never run here):",
        "  dp (batch sharding): no collective",
    ]
    for P in (2, 4, 8):
        p = keyswitch_mp_projection(P, t1_ks_ms, ks_batch, alpha,
                                    link_bytes_per_s, collective_ms)
        lines.append(f"  mp KeySwitch P={P}: {p.t_p_ms} ms/batch (compute "
                     f"{p.compute_ms} + comm {p.comm_ms}) speedup {p.speedup}x "
                     f"eff {p.efficiency:.2f}")
    for P in (2, 4, 8):
        p = keyswitch_hoisted_mp_projection(P, t1_ks_ms, t1_hoisted_ms, ks_batch,
                                            alpha, link_bytes_per_s,
                                            collective_ms)
        lines.append(f"  mp hoisted apply P={P}: {p.t_p_ms} ms/batch (compute "
                     f"{p.compute_ms} + comm {p.comm_ms}) speedup {p.speedup}x "
                     f"eff {p.efficiency:.2f}")
    for P in (2, 4, 8):
        p = dist_ntt_sp_projection(P, t1_ntt_ms, ntt_batch, link_bytes_per_s,
                                   collective_ms, chunks=1,
                                   bytes_per_coeff=binary_exchange_bytes_per_coeff(P))
        lines.append(f"  sp NTT n=16384 B={ntt_batch} P={P}: {p.t_p_ms} ms "
                     f"(comm {p.comm_ms}) speedup {p.speedup}x eff "
                     f"{p.efficiency:.2f}")
    return "\n".join(lines)
