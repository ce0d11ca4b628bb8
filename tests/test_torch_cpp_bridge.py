"""The C++ runtime served by the port (`hexl_fpga_tpu_torch/cpp_bridge.py`) on
the CPU: the port's own g++ build of `cpp/`, `register_torch_backend(device=
"cpu")` over the v1 and the v2 plug-in ABI against the golden model, the
frozen vectors, the native CPU path and the reference's bridge
(`hexl_fpga_tpu.cpp_bridge`, `register_jax_backend` on the CPU), and the
native wire codec.  Tolerance: zero.

The reference's runtime is its own `NativeRuntime` class over a copy of the
same library at another path: a dlopen and a `DevicePool` of its own, and no
cmake build into `cpp/build/`, which `tests/test_cpp_shim.py` makes and would
race under xdist."""

import ctypes
import os
import shutil
import sys
import threading

import numpy as np
import pytest
import torch

from hexl_fpga_tpu import cpp_bridge as ref_bridge
from hexl_fpga_tpu.ops import golden, nt, twiddles, wirepack as jwirepack
from hexl_fpga_tpu_torch import cpp_bridge
from hexl_fpga_tpu_torch.ops import _build, _native, ntt_cuda, wirepack
from hexl_fpga_tpu_torch.runtime import executors, scheduler as sched
from hexl_fpga_tpu_torch.utils import keycache, vectors

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ to build the native runtime")

TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")
SMALL_VECTORS = ["1024_2_3_3_2_0", "1024_2_3_3_2_1", "1024_5_7_6_2_0",
                 "2048_3_4_4_2_0"]
DYADIC_MODULI = np.array([(1 << 40) + 79, (1 << 44) + 43], dtype=np.uint64)
MASK52 = np.uint64((1 << 52) - 1)


def _acquire(runtime):
    """The pool reads its knobs once, when created: batch 1 and the backend
    route (RUN_CHOICE >= 1), whatever an earlier test left in the env."""
    keep = {k: os.environ.pop(k, None) for k in (
        "RUN_CHOICE", "NUM_DEV", "BATCH_SIZE_DYADIC_MULTIPLY", "BATCH_SIZE_NTT",
        "BATCH_SIZE_INTT", "BATCH_SIZE_KEYSWITCH")}
    os.environ["RUN_CHOICE"] = "2"
    try:
        runtime.acquire()
    finally:
        for k, v in keep.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


@pytest.fixture(scope="module")
def rt():
    runtime = cpp_bridge.NativeRuntime()
    _acquire(runtime)
    yield runtime
    runtime.clear_backend()
    runtime.release()


@pytest.fixture(scope="module")
def ref_rt(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "libhexl_fpga_tpu.so"
    shutil.copy(cpp_bridge.build_library(), path)
    runtime = ref_bridge.NativeRuntime(lib_path=path)
    _acquire(runtime)
    yield runtime
    runtime.clear_backend()
    runtime.release()


@pytest.fixture
def torch_backend(rt):
    """Registers the port's backend on the CPU (v1, or v1 + v2) and clears
    it and the counts afterwards."""
    def register(pipelined):
        rt.backend_stats(clear=True)
        rt.register_torch_backend(pipelined=pipelined, device="cpu")
        return rt

    yield register
    rt.clear_backend()
    rt.backend_stats(clear=True)


def served(stats, abi, op):
    return stats["batches"].get(abi, {}).get(op, 0)


def dyadic_ops(seed, count, n=256):
    rng = np.random.default_rng(seed)
    M = len(DYADIC_MODULI)
    return ([rng.integers(0, DYADIC_MODULI.min(), size=2 * M * n, dtype=np.uint64)
             for _ in range(count)],
            [rng.integers(0, DYADIC_MODULI.min(), size=2 * M * n, dtype=np.uint64)
             for _ in range(count)])


def keyswitch_args(v):
    return (v.coeff_count, v.decomp_modulus_size, v.key_modulus_size,
            v.rns_modulus_size, v.key_component_count, v.moduli,
            v.key_vectors, v.modswitch_factors, v.twiddle_factors)


def test_abi_structs_match_the_reference():
    """Field for field the reference's ctypes mirror of
    cpp/include/hexl_tpu_backend.h, at the same offsets."""
    for name in ("DyadicOp", "KeySwitchOp", "NttOp", "BackendV1", "BackendV2"):
        mine, ref = getattr(cpp_bridge, name), getattr(ref_bridge, name)
        assert [f[0] for f in mine._fields_] == [f[0] for f in ref._fields_], name
        assert ctypes.sizeof(mine) == ctypes.sizeof(ref), name
        for field, _ in mine._fields_:
            assert getattr(mine, field).offset == getattr(ref, field).offset


def test_library_is_the_ports_own_build(rt):
    """g++ of cpp/src into the package's _build/, named by a hash of the
    sources and flags; never the reference's cpp/build/ cache."""
    path = cpp_bridge.build_library()
    assert rt.lib._name == path == cpp_bridge.library_path()
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("libhexl_fpga_tpu_")
    assert "-fPIC" in _native.cxx_flags(_native.find_cxx())
    assert not path.startswith(os.path.join(_native.CPP_DIR, "build"))


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """A source that does not compile: build_library raises with g++'s
    message, and leaves no library and no temporary files behind."""
    cpp = tmp_path / "cpp"
    shutil.copytree(_native.CPP_DIR, cpp, ignore=shutil.ignore_patterns("build"))
    with open(cpp / "src" / "compute.cpp", "a") as f:
        f.write("\nint broken_on_purpose( {\n")
    monkeypatch.setattr(_native, "CPP_DIR", str(cpp))
    monkeypatch.setattr(_native, "CPP_SOURCES", ("compute.cpp", "capi.cpp"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="compute.cpp") as e:
        cpp_bridge.build_library()
    assert "error" in str(e.value)
    assert os.listdir(tmp_path / "_build") == []


@pytest.mark.parametrize("pipelined", [False, True], ids=["v1", "v2"])
def test_dyadic_and_transforms_match_golden_and_the_reference(
        rt, ref_rt, torch_backend, pipelined):
    """DyadicMultiply at n = 256 under two moduli and _NTT / _INTT at n = 1024
    with the caller's tables: the port's backend = golden = the reference's
    JAX backend through its own runtime."""
    torch_backend(pipelined)
    ref_rt.register_jax_backend(pipelined=pipelined)
    try:
        (a,), (b,) = dyadic_ops(2, 1)
        n, M = 256, len(DYADIC_MODULI)
        got = rt.dyadic_multiply(a, b, n, DYADIC_MODULI)
        np.testing.assert_array_equal(
            got, golden.dyadic_multiply(a, b, n, DYADIC_MODULI, M))
        np.testing.assert_array_equal(
            got, ref_rt.dyadic_multiply(a, b, n, DYADIC_MODULI))

        q = nt.generate_primes(1, 45, 1024)[0]
        t = twiddles.ntt_tables(1024, q)
        x = np.random.default_rng(3).integers(0, q, size=1024, dtype=np.uint64)
        fwd = rt.ntt(x, t.fwd, t.fwd_precon, q, 1024)
        np.testing.assert_array_equal(fwd, golden.fwd_ntt(x, q, t))
        np.testing.assert_array_equal(
            fwd, ref_rt.ntt(x, t.fwd, t.fwd_precon, q, 1024))
        inv_args = (t.inv, t.inv_precon, q, t.inv_n, t.inv_n_w, 1024)
        back = rt.intt(fwd, *inv_args)
        np.testing.assert_array_equal(back, x)
        np.testing.assert_array_equal(back, ref_rt.intt(fwd, *inv_args))
    finally:
        ref_rt.clear_backend()
    stats = rt.backend_stats()
    abi = "v2" if pipelined else "v1"
    assert stats["batches"] == {abi: {"DYADIC_MULTIPLY": 1, "NTT": 1, "INTT": 1}}
    assert stats["declines"] == [] and stats["errors"] == []


@pytest.mark.parametrize("pipelined", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("name", SMALL_VECTORS)
def test_keyswitch_frozen_vectors(rt, torch_backend, name, pipelined):
    """hexl_tpu_keyswitch through the port's backend gives each small frozen
    vector's expected_output, as the native path does."""
    v = vectors.load_json(os.path.join(TESTDATA, f"{name}.json"))
    native = rt.keyswitch(v.input, v.t_target_iter_ptr, *keyswitch_args(v))
    np.testing.assert_array_equal(native, v.expected_output)
    torch_backend(pipelined)
    got = rt.keyswitch(v.input, v.t_target_iter_ptr, *keyswitch_args(v))
    np.testing.assert_array_equal(got, v.expected_output)
    stats = rt.backend_stats()
    assert served(stats, "v2" if pipelined else "v1", "KEYSWITCH") == 1
    assert stats["declines"] == [] and stats["errors"] == []


def test_dyadic_stream_at_batch_1_overlaps_submit_and_finalize(rt, torch_backend):
    """Five batches of one op under v2: submit i+1 comes before finalize i;
    every op is golden's."""
    torch_backend(True)
    ops1, ops2 = dyadic_ops(4, 5)
    outs = rt.dyadic_multiply(ops1, ops2, 256, DYADIC_MODULI)
    for a, b, got in zip(ops1, ops2, outs):
        np.testing.assert_array_equal(
            got, golden.dyadic_multiply(a, b, 256, DYADIC_MODULI, 2))
    stats = rt.backend_stats()
    assert stats["batches"] == {"v2": {"DYADIC_MULTIPLY": 5}}
    assert stats["threads"] == 1 and stats["errors"] == []


def test_same_result_accumulate_hazard(rt, torch_backend):
    """Two KeySwitch ops accumulating into ONE result buffer in one worksize
    under v2: the C++ scheduler finalizes the first before the second's
    submit reads the buffer (`runtime.cpp` HasRawHazard)."""
    torch_backend(True)
    n, L, K = 1024, 2, 3
    v = vectors.make_keyswitch_vector(n, L, K, seed=7, modulus_bits=45)
    def p(a):
        return cpp_bridge._np_ptr(np.ascontiguousarray(a, dtype=np.uint64))

    result = np.array(v.input, dtype=np.uint64)
    args = [np.ascontiguousarray(a, dtype=np.uint64) for a in (
        v.t_target_iter_ptr, v.moduli, v.modswitch_factors, v.twiddle_factors)]
    t, moduli, msf, tw = (p(a) for a in args)
    keys = [np.ascontiguousarray(k, dtype=np.uint64) for k in v.key_vectors]
    key_arr = (cpp_bridge.u64_p * L)(*[p(k) for k in keys])
    rt.lib.hexl_tpu_set_worksize_keyswitch(2)
    for _ in range(2):
        rt.lib.hexl_tpu_keyswitch(p(result), t, n, L, K, L + 1, 2, moduli,
                                  key_arr, msf, tw)
    rt.lib.hexl_tpu_keyswitch_completed()
    want = v.input
    for _ in range(2):
        want = golden.keyswitch(want, v.t_target_iter_ptr, n, L, K, L + 1, 2,
                                v.moduli, v.key_vectors, v.modswitch_factors,
                                v.twiddle_factors)
    np.testing.assert_array_equal(result, want)
    stats = rt.backend_stats()
    assert served(stats, "v2", "KEYSWITCH") == 2 and stats["errors"] == []


@pytest.mark.parametrize("fail", [None, "second submit", "last finalize"])
@pytest.mark.parametrize("abi", ["v1", "v2"])
def test_a_batch_whose_ops_alias_runs_them_in_order(abi, fail, monkeypatch):
    """Two KeySwitch ops into one result within ONE batch (the C++ scheduler
    batches them when both are queued before its worker wakes): the backend
    runs them as two pieces in order, as the native path would.  If the
    second piece fails, the result is put back as it was (the native path
    then reruns the whole batch) and the failure is recorded."""
    if fail is not None:
        real, calls = executors.TorchExecutor.submit_keyswitch, []

        def second_fails(self, batch):
            calls.append(len(batch))
            fin = real(self, batch)
            if len(calls) == 2 and fail == "second submit":
                raise RuntimeError("forced failure")

            def finalize():
                fin()
                if len(calls) == 2 and fail == "last finalize":
                    raise RuntimeError("forced failure")
            return finalize

        monkeypatch.setattr(executors.TorchExecutor, "submit_keyswitch", second_fails)
    records = []
    backend = cpp_bridge._TorchBackend(
        torch.device("cpu"), lambda kind, entry: records.append((kind, entry)))
    n, L, K = 1024, 2, 3
    v = vectors.make_keyswitch_vector(n, L, K, seed=8, modulus_bits=45)
    keep = [np.ascontiguousarray(a, dtype=np.uint64) for a in (
        v.t_target_iter_ptr, v.moduli, v.modswitch_factors, v.twiddle_factors,
        *v.key_vectors)]
    t, moduli, msf, tw, *keys = (cpp_bridge._np_ptr(a) for a in keep)
    result = np.array(v.input, dtype=np.uint64)
    op = cpp_bridge.KeySwitchOp(
        result=cpp_bridge._np_ptr(result), t_target=t, n=n,
        decomp_modulus_size=L, key_modulus_size=K, rns_modulus_size=L + 1,
        key_component_count=2, moduli=moduli,
        k_switch_keys=(cpp_bridge.u64_p * L)(*keys), modswitch_factors=msf,
        twiddle_factors=tw)
    ops = (cpp_bridge.KeySwitchOp * 2)(op, op)
    if abi == "v1":
        served = backend.run_keyswitch(None, ops, 2)
    else:
        handle = backend.submit_keyswitch(None, ops, 2)
        served = handle and backend.finalize(None, handle)
    if fail is not None:
        assert served == 0 and [k for k, _ in records] == ["errors"]
        assert "forced failure" in records[0][1]["error"]
        np.testing.assert_array_equal(result, v.input)  # untouched
        return
    assert served == 1
    want = v.input
    for _ in range(2):
        want = golden.keyswitch(want, v.t_target_iter_ptr, n, L, K, L + 1, 2,
                                v.moduli, v.key_vectors, v.modswitch_factors,
                                v.twiddle_factors)
    np.testing.assert_array_equal(result, want)
    assert records == [("served", (abi, "KEYSWITCH", 2))]


def test_worker_threads_share_the_backend_without_lost_updates():
    """More callback threads than cores, switching often, on one backend:
    each thread its own executor, every handle distinct, every result
    right, every served batch counted, and one key set staged once."""
    records, lock = [], threading.Lock()

    def record(kind, entry):
        with lock:
            records.append((kind, entry))

    backend = cpp_bridge._TorchBackend(torch.device("cpu"), record)
    v = vectors.make_keyswitch_vector(1024, 2, 3, seed=12, modulus_bits=45)
    keep = [np.ascontiguousarray(a, dtype=np.uint64) for a in (
        v.t_target_iter_ptr, v.moduli, v.modswitch_factors, v.twiddle_factors,
        *v.key_vectors)]
    t, moduli, msf, tw, *keys = (cpp_bridge._np_ptr(a) for a in keep)
    key_arr = (cpp_bridge.u64_p * 2)(*keys)
    threads_n, per_thread = 2 * (os.cpu_count() or 4), 1
    results = [np.array(v.input, dtype=np.uint64)
               for _ in range(threads_n * per_thread)]
    handles, failures = [], []

    def worker(k):
        try:
            for i in range(per_thread):
                r = results[k * per_thread + i]
                op = cpp_bridge.KeySwitchOp(
                    result=cpp_bridge._np_ptr(r), t_target=t, n=1024,
                    decomp_modulus_size=2, key_modulus_size=3,
                    rns_modulus_size=3, key_component_count=2, moduli=moduli,
                    k_switch_keys=key_arr, modswitch_factors=msf,
                    twiddle_factors=tw)
                h = backend.submit_keyswitch(None, (cpp_bridge.KeySwitchOp * 1)(op), 1)
                with lock:
                    handles.append(h)
                assert h and backend.finalize(None, h) == 1
        except Exception as e:  # reported by the main thread
            failures.append(e)

    keycache.UPLOADS["key_sets"] = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=worker, args=(k,)) for k in range(threads_n)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=120)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert failures == []
    assert len(set(handles)) == len(results)
    assert len(backend._executors) == threads_n
    for r in results:
        np.testing.assert_array_equal(r, v.expected_output)
    assert records == [("served", ("v2", "KEYSWITCH", 1))] * len(results)
    assert keycache.UPLOADS["key_sets"] == 1


def test_one_key_upload_per_key_set(rt, torch_backend):
    """A stream of batches over one key set uploads it once (the views are
    kept per key pointer); new key arrays upload once more."""
    torch_backend(True)
    v = vectors.make_keyswitch_vector(1024, 2, 3, seed=9, modulus_bits=45)
    keycache.UPLOADS["key_sets"] = 0
    for i in range(4):
        got = rt.keyswitch(v.input, v.t_target_iter_ptr, *keyswitch_args(v))
        np.testing.assert_array_equal(got, v.expected_output, err_msg=f"op {i}")
    assert keycache.UPLOADS["key_sets"] == 1
    v.key_vectors = [k.copy() for k in v.key_vectors]
    got = rt.keyswitch(v.input, v.t_target_iter_ptr, *keyswitch_args(v))
    np.testing.assert_array_equal(got, v.expected_output)
    assert keycache.UPLOADS["key_sets"] == 2
    assert served(rt.backend_stats(), "v2", "KEYSWITCH") == 5


@pytest.mark.parametrize("where", ["submit", "finalize"])
def test_failure_is_recorded_and_the_native_rerun_is_right(
        rt, torch_backend, monkeypatch, where):
    """An exception in a callback returns 0, the native path reruns the
    batch with the right answer, backend_stats() holds the exception and
    its traceback, and the caller's *_completed raises; nothing is retried
    through v1."""
    def boom(self, batch):
        if where == "submit":
            raise RuntimeError("forced failure")

        def fin():
            raise RuntimeError("forced failure")
        return fin

    monkeypatch.setattr(executors.TorchExecutor, "submit_dyadic_multiply", boom)
    torch_backend(True)
    (a,), (b,) = dyadic_ops(5, 1)
    P = cpp_bridge._np_ptr
    got = np.zeros(3 * 2 * 256, dtype=np.uint64)
    rt.lib.hexl_tpu_set_worksize_dyadic_multiply(1)
    rt.lib.hexl_tpu_dyadic_multiply(P(got), P(a), P(b), 256, P(DYADIC_MODULI), 2)
    with pytest.raises(cpp_bridge.BackendError, match="forced failure"):
        rt.lib.hexl_tpu_dyadic_multiply_completed()
    np.testing.assert_array_equal(
        got, golden.dyadic_multiply(a, b, 256, DYADIC_MODULI, 2))
    stats = rt.backend_stats()
    assert [e["abi"] for e in stats["errors"]] == ["v2"]
    for e in stats["errors"]:
        assert e["op"] == "DYADIC_MULTIPLY" and "forced failure" in e["error"]
        assert "forced failure" in e["traceback"]
        assert "test_torch_cpp_bridge.py" in e["traceback"]
        assert e["shape"] == {"count": 1, "n": 256, "n_moduli": 2}
    assert stats["batches"] == {} and stats["declines"] == []


def test_a_fault_stands_until_the_backend_is_registered_again(
        rt, torch_backend, monkeypatch):
    """After a callback failed, every call of the runtime raises (an op
    call with no worksize after its native rerun) until the backend is
    registered again; then the card's route serves as before."""
    def boom(self, batch):
        raise RuntimeError("forced failure")

    monkeypatch.setattr(executors.TorchExecutor, "submit_dyadic_multiply", boom)
    torch_backend(True)
    (a,), (b,) = dyadic_ops(6, 1)
    want = golden.dyadic_multiply(a, b, 256, DYADIC_MODULI, 2)
    P = cpp_bridge._np_ptr
    got = np.zeros(3 * 2 * 256, dtype=np.uint64)
    with pytest.raises(cpp_bridge.BackendError, match="forced failure"):
        rt.lib.hexl_tpu_dyadic_multiply(P(got), P(a), P(b), 256, P(DYADIC_MODULI), 2)
    np.testing.assert_array_equal(got, want)  # the native rerun
    for call in (lambda: rt.dyadic_multiply(a, b, 256, DYADIC_MODULI),
                 lambda: rt.lib.hexl_tpu_set_worksize_keyswitch(1),
                 rt.lib.hexl_tpu_ntt_completed):
        with pytest.raises(cpp_bridge.BackendError):
            call()
    assert len(rt.backend_stats()["errors"]) == 1
    monkeypatch.undo()
    torch_backend(True)
    np.testing.assert_array_equal(rt.dyadic_multiply(a, b, 256, DYADIC_MODULI), want)
    stats = rt.backend_stats()
    assert stats["batches"] == {"v2": {"DYADIC_MULTIPLY": 1}} and stats["errors"] == []


def test_a_fault_for_a_cpp_caller_aborts_the_process():
    """A C++ caller (here a second handle on the same library, which the
    runtime's guards do not see) cannot be raised to: the process aborts
    with the traceback rather than let the native rerun hide the fault."""
    import subprocess

    code = (
        "import ctypes, resource\n"
        "import numpy as np\n"
        "resource.setrlimit(resource.RLIMIT_CORE, (0, 0))\n"
        "from hexl_fpga_tpu_torch import cpp_bridge\n"
        "from hexl_fpga_tpu_torch.runtime import executors\n"
        "def boom(self, batch):\n"
        "    raise RuntimeError('forced failure')\n"
        "executors.TorchExecutor.submit_dyadic_multiply = boom\n"
        "rt = cpp_bridge.NativeRuntime(); rt.acquire()\n"
        "rt.register_torch_backend(device='cpu')\n"
        "c = ctypes.CDLL(rt.lib._name)\n"
        "P = cpp_bridge._np_ptr\n"
        "c.hexl_tpu_dyadic_multiply.argtypes = [cpp_bridge.u64_p] * 3 + "
        "[ctypes.c_uint64, cpp_bridge.u64_p, ctypes.c_uint64]\n"
        "q = np.array([65537], dtype=np.uint64)\n"
        "a = np.ones(2 * 64, dtype=np.uint64); out = np.zeros(3 * 64, dtype=np.uint64)\n"
        "c.hexl_tpu_dyadic_multiply(P(out), P(a), P(a), 64, P(q), 1)\n"
        "print('not reached')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env={**os.environ, "RUN_CHOICE": "2"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == -6, (res.returncode, res.stderr)
    assert "not reached" not in res.stdout
    assert "for a C++ caller" in res.stderr and "forced failure" in res.stderr


def test_a_card_registration_that_cannot_build_raises_and_installs_nothing(
        rt, torch_backend, monkeypatch):
    """On the card the kernels are built before any table is installed: a
    build that fails raises from register_torch_backend, and the table
    registered before it stays."""
    torch_backend(True)

    def no_build():
        raise RuntimeError("forced build failure")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(ntt_cuda, "build_kernels", no_build)
    with pytest.raises(RuntimeError, match="forced build failure"):
        rt.register_torch_backend()
    monkeypatch.undo()
    (a,), (b,) = dyadic_ops(7, 1)
    np.testing.assert_array_equal(
        rt.dyadic_multiply(a, b, 256, DYADIC_MODULI),
        golden.dyadic_multiply(a, b, 256, DYADIC_MODULI, 2))
    assert rt.backend_stats()["batches"] == {"v2": {"DYADIC_MULTIPLY": 1}}


def test_declined_shape_is_recorded(rt, torch_backend):
    """A modulus below 2 is a shape no dyadic route of the port serves: the
    batch is declined once, by v2 (no v1 table is installed beside it),
    with its reason, and runs natively; a decline is no fault."""
    torch_backend(True)
    moduli = np.array([1, 17], dtype=np.uint64)
    a = np.arange(2 * 2 * 8, dtype=np.uint64) % np.uint64(17)
    got = rt.dyadic_multiply(a, a, 8, moduli)
    np.testing.assert_array_equal(got, golden.dyadic_multiply(a, a, 8, moduli, 2))
    stats = rt.backend_stats()
    assert [d["abi"] for d in stats["declines"]] == ["v2"]
    for d in stats["declines"]:
        assert d["op"] == "DYADIC_MULTIPLY" and ">= 2" in d["reason"]
        assert d["shape"] == {"count": 1, "n": 8, "n_moduli": 2}
    assert stats["batches"] == {} and stats["errors"] == []


def test_a_process_exits_cleanly_with_a_backend_registered():
    """The atexit hook clears the tables while the pool still holds them:
    the interpreter exits 0 with a backend registered and the pool alive."""
    import subprocess

    code = (
        "import numpy as np\n"
        "from hexl_fpga_tpu_torch.cpp_bridge import NativeRuntime\n"
        "rt = NativeRuntime(); rt.acquire()\n"
        "rt.register_torch_backend(device='cpu')\n"
        "q = np.array([65537], dtype=np.uint64)\n"
        "a = np.ones(2 * 64, dtype=np.uint64)\n"
        "assert (rt.dyadic_multiply(a, a, 64, q) == [1] * 64 + [2] * 64 + [1] * 64).all()\n"
        "assert rt.backend_stats()['batches'] == {'v2': {'DYADIC_MULTIPLY': 1}}\n"
        "print('done')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env={**os.environ, "RUN_CHOICE": "2"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "done"


def test_register_without_a_device_raises_without_cuda(rt):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rt.register_torch_backend(device=device)
    with pytest.raises(ValueError):
        rt.register_torch_backend(device="meta")


def test_port_and_reference_runtimes_keep_separate_pools(rt, ref_rt, torch_backend):
    """A backend registered on one runtime is never called by the other."""
    torch_backend(True)
    calls = []

    def spy(ctx, ops, count):
        calls.append(count)
        return 0  # decline: the reference's runtime computes natively

    never = ref_bridge.KEYSWITCH_CB(lambda *a: 0)
    spy_table = ref_bridge.BackendV1(
        run_dyadic_batch=ref_bridge.DYADIC_CB(spy),
        run_keyswitch_batch=never, run_ntt_batch=ref_bridge.NTT_CB(lambda *a: 0),
        ctx=None)
    ref_rt.lib.hexl_tpu_register_backend(ctypes.byref(spy_table))
    try:
        (a,), (b,) = dyadic_ops(6, 1)
        want = golden.dyadic_multiply(a, b, 256, DYADIC_MODULI, 2)
        np.testing.assert_array_equal(ref_rt.dyadic_multiply(a, b, 256, DYADIC_MODULI), want)
        assert calls == [1]
        assert rt.backend_stats()["batches"] == {}
        np.testing.assert_array_equal(rt.dyadic_multiply(a, b, 256, DYADIC_MODULI), want)
        assert calls == [1]
        assert rt.backend_stats()["batches"] == {"v2": {"DYADIC_MULTIPLY": 1}}
    finally:
        ref_rt.clear_backend()


@pytest.mark.parametrize("shape", [(8,), (3, 64), (2, 2, 1024)])
@pytest.mark.parametrize("bits", [52, 64])
def test_native_codec_matches_numpy_and_the_reference(shape, bits):
    """The C++ codec's bits are pack_u64_np's and the reference's pack_np's,
    both ways; 64-bit draws exercise the masking."""
    x = np.random.default_rng(sum(shape) + bits).integers(
        0, 1 << bits, size=shape, dtype=np.uint64)
    packed = wirepack.pack_u64_native(x)
    np.testing.assert_array_equal(packed, wirepack.pack_u64_np(x))
    np.testing.assert_array_equal(packed, jwirepack.pack_np(x.view(np.uint32)))
    back = wirepack.unpack_u64_native(packed)
    np.testing.assert_array_equal(back, wirepack.unpack_u64_np(packed))
    np.testing.assert_array_equal(back, x & MASK52)
    np.testing.assert_array_equal(back.view(np.uint32), jwirepack.unpack_np(packed))


def test_out_of_domain_value_corrupts_only_its_own_field_natively():
    x = np.random.default_rng(5).integers(0, 1 << 52, size=(2, 16), dtype=np.uint64)
    bad = x.copy()
    bad[0, 3] |= np.uint64(0xFFF) << np.uint64(52)
    bad[1, 7] = np.uint64((1 << 64) - 1)
    got = wirepack.unpack_u64_native(wirepack.pack_u64_native(bad))
    np.testing.assert_array_equal(got, bad & MASK52)
    keep = np.ones_like(x, dtype=bool)
    keep[0, 3] = keep[1, 7] = False
    np.testing.assert_array_equal(got[keep], x[keep])


def test_packed_route_uses_the_native_codec(monkeypatch):
    """HEXL_TPU_WIRE_PACK=1 packs and unpacks on the host with the native
    codec whatever the device (NumPy's is only the tests' oracle), and
    gives the unpacked route's bits."""
    used = []
    for name in ("pack_u64_native", "unpack_u64_native"):
        fn = getattr(wirepack, name)
        monkeypatch.setattr(wirepack, name,
                            lambda a, fn=fn, name=name: used.append(name) or fn(a))
    for name in ("pack_u64_np", "unpack_u64_np"):
        monkeypatch.setattr(wirepack, name, None)
    v = vectors.load_json(os.path.join(TESTDATA, f"{SMALL_VECTORS[0]}.json"))
    ex = executors.TorchExecutor(0, force_cpu=True)
    item = {"result": np.array(v.input, dtype=np.uint64),
            "t_target": v.t_target_iter_ptr, "n": v.coeff_count,
            "decomp_modulus_size": v.decomp_modulus_size,
            "key_modulus_size": v.key_modulus_size,
            "rns_modulus_size": v.rns_modulus_size,
            "key_component_count": v.key_component_count, "moduli": v.moduli,
            "k_switch_keys": v.key_vectors,
            "modswitch_factors": v.modswitch_factors,
            "twiddle_factors": v.twiddle_factors}
    monkeypatch.setenv("HEXL_TPU_WIRE_PACK", "1")
    ex.run_keyswitch([sched.WorkItem("KEYSWITCH", item)])
    np.testing.assert_array_equal(item["result"], v.expected_output)
    assert used == ["pack_u64_native", "pack_u64_native", "unpack_u64_native"]


def test_scatter_checks_every_buffer_before_the_first_write():
    """A finalize's scatter that fails has written nothing: a batch whose
    second buffer is read-only raises with the first buffer untouched."""
    bufs = [np.zeros(8, dtype=np.uint64) for _ in range(2)]
    bufs[1].flags.writeable = False
    batch = [sched.WorkItem("NTT", {"operand": b}) for b in bufs]
    with pytest.raises(ValueError, match="writable"):
        executors._scatter_to(batch, "operand")(np.ones((2, 8), dtype=np.uint64))
    assert not bufs[0].any()
