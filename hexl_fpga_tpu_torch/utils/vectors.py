"""KeySwitch test-vector generation and JSON (de)serialization.

The JSON schema matches the reference's recorded vectors exactly
(`tests/test_keyswitch.cpp:55-104`): coeff_count, decomp_modulus_size,
key_modulus_size, rns_modulus_size, key_component_count, moduli,
modswitch_factors, the four twiddle tables ([K][n] each), key_vector
([decomp][2*K*n]), t_target_iter_ptr, input, expected_output.  File names
encode the config: `{N}_{decomp}_{key}_{rns}_{kcomp}_{seed}.json`
(`tests/test_keyswitch.cpp:148-191`).

Because the reference's vectors are only distributed as a release download,
this module can also *generate* semantically-valid vectors: it builds genuine
RLWE switching keys (SEAL-style RNS gadget: key[i] is an encryption of
P * s_old under s_new with the P*s_old term added to the i-th limb only) and
records the golden model's output as `expected_output`.  The semantic
correctness of the golden model itself is established by
`tests/test_keyswitch_golden.py::test_keyswitch_is_rlwe_keyswitch`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List

import numpy as np

from ..ops import golden, nt, twiddles


@dataclass
class KeySwitchVector:
    coeff_count: int
    decomp_modulus_size: int
    key_modulus_size: int
    rns_modulus_size: int
    key_component_count: int
    moduli: List[int]
    modswitch_factors: List[int]
    twiddle_factors: np.ndarray  # (K*4*n,) keyswitch host layout, or None
    key_vectors: List[np.ndarray]  # decomp x (2*K*n,)
    t_target_iter_ptr: np.ndarray  # (decomp*n,)
    input: np.ndarray  # (2*decomp*n,)
    expected_output: np.ndarray  # (2*decomp*n,)

    @property
    def config_name(self) -> str:
        return (
            f"{self.coeff_count}_{self.decomp_modulus_size}_{self.key_modulus_size}"
            f"_{self.rns_modulus_size}_{self.key_component_count}"
        )


def _negacyclic_mul(a: List[int], b: List[int], q: int) -> List[int]:
    """Exact negacyclic product mod q (schoolbook; used only for tiny n in
    RLWE-level verification — key generation below uses the NTT instead)."""
    n = len(a)
    out = [0] * n
    for i, ai in enumerate(a):
        if ai == 0:
            continue
        for j, bj in enumerate(b):
            k = i + j
            if k < n:
                out[k] = (out[k] + ai * bj) % q
            else:
                out[k - n] = (out[k - n] - ai * bj) % q
    return out


def _mul_mod_obj(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    """Elementwise (a * b) mod q, exact via python-int object arrays."""
    return ((a.astype(object) * b.astype(object)) % q).astype(np.uint64)


def make_keyswitch_vector(
    n: int,
    decomp_modulus_size: int,
    key_modulus_size: int,
    seed: int = 0,
    modulus_bits: int = 50,
    noise_bound: int = 3,
    nonzero_input: bool = True,
    plain_modulus: int | None = None,
    moduli: List[int] | None = None,
) -> KeySwitchVector:
    """Generate one semantically-valid keyswitch vector.

    Returns the vector with `expected_output` filled in by the golden model.
    Also stores (in `.aux`) the secrets/plaintext needed for RLWE-level
    verification.

    plain_modulus (BGV mode): key errors are scaled by t (BGV switching keys
    encrypt P*s_old with noise t*e) and `expected_output` comes from the
    golden model's BGV tail (golden.keyswitch plain_modulus), whose rounding
    delta is divisible by t — so the keyswitch noise is == 0 (mod t) and the
    BGV message survives exactly (test_keyswitch_bgv.py proves it).

    moduli: the K moduli (the last the special prime), each q = 1 mod 2n, in
    place of nt.generate_primes(K, modulus_bits, n)."""
    rng = np.random.default_rng(seed)
    t_scale = 1 if plain_modulus is None else int(plain_modulus)
    L, K = decomp_modulus_size, key_modulus_size
    if moduli is None:
        moduli = nt.generate_primes(K, modulus_bits, n)
    moduli = [int(q) for q in moduli]
    if len(moduli) != K or any(q % (2 * n) != 1 for q in moduli):
        raise ValueError(f"need {K} moduli q = 1 mod {2 * n}, got {moduli}")
    P = moduli[K - 1]
    QP = 1
    for q in moduli:
        QP *= q

    tabs = [twiddles.ntt_tables(n, q) for q in moduli]

    def to_ntt(coeffs: List[int], j: int) -> np.ndarray:
        q = moduli[j]
        arr = np.array([c % q for c in coeffs], dtype=np.uint64)
        return golden.fwd_ntt(arr, q, tabs[j])

    # ternary secrets
    s_new = [int(v) for v in rng.integers(-1, 2, size=n)]
    s_old = [int(v) for v in rng.integers(-1, 2, size=n)]

    # switching keys: key[i] = (-(a_i*s_new) + e_i [+ P*s_old on limb i], a_i).
    # The negacyclic product -a*s is computed in the NTT domain (elementwise
    # multiply of the transforms — exact, and O(n log n) instead of the
    # schoolbook O(n^2) which is intractable at n=16384).
    sn_ntt = [to_ntt(s_new, j) for j in range(K)]
    key_vectors = []
    for i in range(L):
        a_int = [int(rng.integers(0, 1 << 62)) % QP for _ in range(n)]
        e = [int(v) for v in rng.integers(-noise_bound, noise_bound + 1, size=n)]
        comp0 = np.zeros((K, n), dtype=np.uint64)
        comp1 = np.zeros((K, n), dtype=np.uint64)
        for j in range(K):
            q = moduli[j]
            a_ntt = to_ntt(a_int, j)
            comp1[j] = a_ntt
            neg_a_ntt = np.where(a_ntt == 0, 0, np.uint64(q) - a_ntt)
            b = golden.inv_ntt(_mul_mod_obj(neg_a_ntt, sn_ntt[j], q), q, tabs[j])
            add = np.array(
                [
                    (t_scale * ev + (P * sv if j == i else 0)) % q
                    for ev, sv in zip(e, s_old)
                ],
                dtype=np.uint64,
            )
            b = ((b.astype(object) + add.astype(object)) % q).astype(np.uint64)
            comp0[j] = golden.fwd_ntt(b, q, tabs[j])
        key_vectors.append(np.concatenate([comp0.ravel(), comp1.ravel()]))

    # target polynomial t (the ciphertext component being switched), as limbs
    t_int = [int(rng.integers(0, 1 << 62)) % QP for _ in range(n)]
    t_target = np.stack([to_ntt(t_int, i) for i in range(L)])  # (L, n) NTT form

    modswitch_factors = [nt.inverse_mod(P % q, q) if q != P else 1 for q in moduli]

    if nonzero_input:
        ct_in = np.stack(
            [
                rng.integers(0, moduli[i % L], size=n, dtype=np.uint64)
                for i in range(2 * L)
            ]
        ).reshape(2, L, n)
    else:
        ct_in = np.zeros((2, L, n), dtype=np.uint64)

    twiddle_factors = twiddles.keyswitch_twiddles(n, moduli)

    expected = golden.keyswitch(
        ct_in.ravel(),
        t_target.ravel(),
        n,
        L,
        K,
        L + 1,
        2,
        moduli,
        key_vectors,
        modswitch_factors,
        twiddle_factors,
        plain_modulus=plain_modulus,
    )

    vec = KeySwitchVector(
        coeff_count=n,
        decomp_modulus_size=L,
        key_modulus_size=K,
        rns_modulus_size=L + 1,
        key_component_count=2,
        moduli=list(moduli),
        modswitch_factors=modswitch_factors,
        twiddle_factors=twiddle_factors,
        key_vectors=key_vectors,
        t_target_iter_ptr=t_target.ravel(),
        input=ct_in.ravel().copy(),
        expected_output=expected,
    )
    vec.aux = {  # type: ignore[attr-defined]
        "s_new": s_new,
        "s_old": s_old,
        "t_int": t_int,
        "QP": QP,
        "P": P,
        "plain_modulus": plain_modulus,
    }
    return vec


def save_json(vec: KeySwitchVector, path: str) -> None:
    n, K = vec.coeff_count, vec.key_modulus_size
    tw = np.asarray(vec.twiddle_factors, dtype=np.uint64).reshape(K, 4, n)
    doc = {
        "coeff_count": vec.coeff_count,
        "decomp_modulus_size": vec.decomp_modulus_size,
        "key_modulus_size": vec.key_modulus_size,
        "rns_modulus_size": vec.rns_modulus_size,
        "key_component_count": vec.key_component_count,
        "moduli": [int(v) for v in vec.moduli],
        "modswitch_factors": [int(v) for v in vec.modswitch_factors],
        "inv_root_of_unity_powers": tw[:, 0, :].tolist(),
        "precon64_inv_root_of_unity_powers": tw[:, 1, :].tolist(),
        "root_of_unity_powers": tw[:, 2, :].tolist(),
        "precon64_root_of_unity_powers": tw[:, 3, :].tolist(),
        "key_vector": [kv.tolist() for kv in vec.key_vectors],
        "t_target_iter_ptr": vec.t_target_iter_ptr.tolist(),
        "input": vec.input.tolist(),
        "expected_output": vec.expected_output.tolist(),
    }
    if path.endswith(".gz"):
        import gzip

        # mtime=0 for byte-stable archives (frozen fixtures are committed)
        with gzip.GzipFile(path, "wb", mtime=0) as f:
            f.write(json.dumps(doc).encode())
    else:
        with open(path, "w") as f:
            json.dump(doc, f)


def load_json(path: str) -> KeySwitchVector:
    if path.endswith(".gz"):
        import gzip

        with gzip.open(path, "rt") as f:
            js = json.load(f)
    else:
        with open(path) as f:
            js = json.load(f)
    n = js["coeff_count"]
    K = js["key_modulus_size"]
    has_tw = all(
        k in js
        for k in (
            "inv_root_of_unity_powers",
            "precon64_inv_root_of_unity_powers",
            "root_of_unity_powers",
            "precon64_root_of_unity_powers",
        )
    )
    tw = None
    if has_tw:
        blocks = []
        for k in range(K):
            for field in (
                "inv_root_of_unity_powers",
                "precon64_inv_root_of_unity_powers",
                "root_of_unity_powers",
                "precon64_root_of_unity_powers",
            ):
                blocks.append(np.array(js[field][k], dtype=np.uint64))
        tw = np.concatenate(blocks)
    return KeySwitchVector(
        coeff_count=n,
        decomp_modulus_size=js["decomp_modulus_size"],
        key_modulus_size=K,
        rns_modulus_size=js["rns_modulus_size"],
        key_component_count=js["key_component_count"],
        moduli=[int(v) for v in js["moduli"]],
        modswitch_factors=[int(v) for v in js["modswitch_factors"]],
        twiddle_factors=tw,
        key_vectors=[np.array(kv, dtype=np.uint64) for kv in js["key_vector"]],
        t_target_iter_ptr=np.array(js["t_target_iter_ptr"], dtype=np.uint64),
        input=np.array(js["input"], dtype=np.uint64),
        expected_output=np.array(js["expected_output"], dtype=np.uint64),
    )
