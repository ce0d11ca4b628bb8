"""ctypes bridge to the native C++ runtime (cpp/ -> libhexl_fpga_tpu.so).

The counterpart of `hexl_fpga_tpu/cpp_bridge.py`.  Two directions:

* drive the C++ `hexl-fpga.h`-compatible API from Python (`NativeRuntime`:
  the same methods as the reference's);
* register the port's torch executors as the C++ runtime's accelerator
  backend (`cpp/include/hexl_tpu_backend.h`, v1 and v2), so a C++ caller of
  `hexl-fpga.h` (a SEAL bridge) runs on the card through the port's
  executor and kernels (`NativeRuntime.register_torch_backend`).

The library is this package's own build of the unchanged `cpp/` sources:
`build_library()` (`ops/_native.py`) compiles them with the host C++
compiler (no cmake) into `_build/` under a name that carries a hash of the
sources and flags, at first use.  It never loads `cpp/build/`, the reference's cache: a second
dlopen of that path would share its `DevicePool` singleton
(`cpp/src/runtime.cpp:109-127`) with the reference's runtime in the same
process.  ctypes loads this one RTLD_LOCAL, so it keeps a pool of its own.
"""

from __future__ import annotations

import atexit
import ctypes
import itertools
import os
import sys
import threading
import traceback
from collections import Counter, OrderedDict
from typing import Optional

import numpy as np
import torch

from .ops import _native, dyadic_cuda, keyswitch_cuda, ntt_cuda
from .ops._native import build_library, library_path  # noqa: F401 (the API)
from .runtime import executors, scheduler as sched

u64_p = ctypes.POINTER(ctypes.c_uint64)
u64_pp = ctypes.POINTER(u64_p)


class DyadicOp(ctypes.Structure):
    _fields_ = [
        ("results", u64_p),
        ("operand1", u64_p),
        ("operand2", u64_p),
        ("n", ctypes.c_uint64),
        ("moduli", u64_p),
        ("n_moduli", ctypes.c_uint64),
    ]


class KeySwitchOp(ctypes.Structure):
    _fields_ = [
        ("result", u64_p),
        ("t_target", u64_p),
        ("n", ctypes.c_uint64),
        ("decomp_modulus_size", ctypes.c_uint64),
        ("key_modulus_size", ctypes.c_uint64),
        ("rns_modulus_size", ctypes.c_uint64),
        ("key_component_count", ctypes.c_uint64),
        ("moduli", u64_p),
        ("k_switch_keys", u64_pp),
        ("modswitch_factors", u64_p),
        ("twiddle_factors", u64_p),
    ]


class NttOp(ctypes.Structure):
    _fields_ = [
        ("operand", u64_p),
        ("root_powers", u64_p),
        ("precon_root_powers", u64_p),
        ("coeff_modulus", ctypes.c_uint64),
        ("inv_n", ctypes.c_uint64),
        ("inv_n_w", ctypes.c_uint64),
        ("n", ctypes.c_uint64),
    ]


DYADIC_CB = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(DyadicOp), ctypes.c_uint64
)
KEYSWITCH_CB = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(KeySwitchOp), ctypes.c_uint64
)
NTT_CB = ctypes.CFUNCTYPE(
    ctypes.c_int,
    ctypes.c_void_p,
    ctypes.POINTER(NttOp),
    ctypes.c_uint64,
    ctypes.c_int,
)


class BackendV1(ctypes.Structure):
    _fields_ = [
        ("run_dyadic_batch", DYADIC_CB),
        ("run_keyswitch_batch", KEYSWITCH_CB),
        ("run_ntt_batch", NTT_CB),
        ("ctx", ctypes.c_void_p),
    ]


# v2 (split submit/finalize): submit returns a nonzero handle (0 = decline),
# finalize blocks until that handle's results are written (0 = failure with
# results untouched -> native rerun).  See cpp/include/hexl_tpu_backend.h.
DYADIC_SUBMIT_CB = ctypes.CFUNCTYPE(
    ctypes.c_uint64, ctypes.c_void_p, ctypes.POINTER(DyadicOp), ctypes.c_uint64
)
KEYSWITCH_SUBMIT_CB = ctypes.CFUNCTYPE(
    ctypes.c_uint64, ctypes.c_void_p, ctypes.POINTER(KeySwitchOp),
    ctypes.c_uint64,
)
NTT_SUBMIT_CB = ctypes.CFUNCTYPE(
    ctypes.c_uint64,
    ctypes.c_void_p,
    ctypes.POINTER(NttOp),
    ctypes.c_uint64,
    ctypes.c_int,
)
FINALIZE_CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_uint64)


class BackendV2(ctypes.Structure):
    _fields_ = [
        ("submit_dyadic_batch", DYADIC_SUBMIT_CB),
        ("submit_keyswitch_batch", KEYSWITCH_SUBMIT_CB),
        ("submit_ntt_batch", NTT_SUBMIT_CB),
        ("finalize_batch", FINALIZE_CB),
        ("ctx", ctypes.c_void_p),
    ]


def _np_ptr(a: np.ndarray):
    return a.ctypes.data_as(u64_p)


def _view(ptr, count: int) -> np.ndarray:
    """A u64 numpy view of `count` values at a C pointer (no copy), of the
    native uint64 dtype: ctypes' explicit little-endian one would make every
    np.asarray(..., dtype=np.uint64) downstream a new array object."""
    return np.ctypeslib.as_array(ptr, shape=(int(count),)).view(np.uint64)


def _address(ptr) -> int:
    return ctypes.cast(ptr, ctypes.c_void_p).value or 0


# the C API's calls of each op: hexl_tpu_set_worksize_<stem>,
# hexl_tpu_<stem> (one op) and hexl_tpu_<stem>_completed
_API_STEMS = {sched.DYADIC_MULTIPLY: "dyadic_multiply", sched.KEYSWITCH: "keyswitch",
              sched.NTT: "ntt", sched.INTT: "intt"}


class BackendError(RuntimeError):
    """The registered torch backend failed in a callback.  The C++ runtime
    reran that batch on its native CPU path (the ABI offers nothing else),
    so the results are right, but the card did not compute them."""


class NativeRuntime:
    """Handle on the loaded C++ runtime, mirroring the public API.

    An exception in a backend callback is a fault of this runtime, and it
    stands until the backend is registered again or cleared: every
    hexl_tpu_set_worksize_* call made through `lib` raises `BackendError`
    from then on, and so does every *_completed call (after its wait) and
    every op call outside a worksize.  A fault while no Python caller of
    this handle has work of that op open came from a C++ caller, which no
    exception can reach: the process then aborts with the traceback, as the
    C++ runtime does on a failed check."""

    def __init__(self, lib_path: Optional[os.PathLike] = None):
        path = os.fspath(lib_path) if lib_path else build_library()
        # CDLL, not PyDLL: the GIL is released around every foreign call, so
        # a C++ worker's callback can run while this thread waits in
        # *_completed()
        self.lib = ctypes.CDLL(path)
        self._keepalive: list = []
        self._stats_lock = threading.Lock()
        self._stats = _empty_stats()
        self._fault = None  # the first error since the last registration
        self._streams: set = set()  # ops a Python caller set a worksize for
        self._sync_calls: Counter = Counter()  # ops in a Python op call, no worksize
        self._registered = False  # a table of ours is in the live pool
        atexit.register(self._clear_at_exit)
        L = self.lib
        for name, argtypes, restype in [
            ("hexl_tpu_acquire", [], None),
            ("hexl_tpu_release", [], None),
            ("hexl_tpu_set_worksize_dyadic_multiply", [ctypes.c_uint64], None),
            (
                "hexl_tpu_dyadic_multiply",
                [u64_p, u64_p, u64_p, ctypes.c_uint64, u64_p, ctypes.c_uint64],
                None,
            ),
            ("hexl_tpu_dyadic_multiply_completed", [], ctypes.c_int),
            ("hexl_tpu_set_worksize_keyswitch", [ctypes.c_uint64], None),
            (
                "hexl_tpu_keyswitch",
                [u64_p, u64_p] + [ctypes.c_uint64] * 5 + [u64_p, u64_pp, u64_p, u64_p],
                None,
            ),
            ("hexl_tpu_keyswitch_completed", [], ctypes.c_int),
            ("hexl_tpu_set_worksize_ntt", [ctypes.c_uint64], None),
            (
                "hexl_tpu_ntt",
                [u64_p, u64_p, u64_p, ctypes.c_uint64, ctypes.c_uint64],
                None,
            ),
            ("hexl_tpu_ntt_completed", [], ctypes.c_int),
            ("hexl_tpu_set_worksize_intt", [ctypes.c_uint64], None),
            (
                "hexl_tpu_intt",
                [u64_p, u64_p, u64_p] + [ctypes.c_uint64] * 4,
                None,
            ),
            ("hexl_tpu_intt_completed", [], ctypes.c_int),
            (
                "hexl_tpu_register_backend",
                [ctypes.POINTER(BackendV1)],
                None,
            ),
            (
                "hexl_tpu_register_backend_v2",
                [ctypes.POINTER(BackendV2)],
                None,
            ),
            (
                "hexl_tpu_minimal_primitive_root",
                [ctypes.c_uint64, ctypes.c_uint64],
                ctypes.c_uint64,
            ),
            (
                "hexl_tpu_make_ntt_tables",
                [ctypes.c_uint64, ctypes.c_uint64] + [u64_p] * 6,
                None,
            ),
            (
                "hexl_tpu_generate_primes",
                [ctypes.c_int, ctypes.c_int, ctypes.c_uint64, u64_p],
                ctypes.c_int,
            ),
        ]:
            fn = getattr(L, name)
            fn.argtypes = argtypes
            fn.restype = restype
        for op, stem in _API_STEMS.items():
            for name, wrap in ((f"hexl_tpu_set_worksize_{stem}", self._set_worksize),
                               (f"hexl_tpu_{stem}", self._op_call),
                               (f"hexl_tpu_{stem}_completed", self._completed)):
                setattr(L, name, wrap(op, getattr(L, name)))

    # --------------------------------------------------- fault guards ----

    def _set_worksize(self, op, fn):
        def call(worksize):
            self._raise_fault()
            with self._stats_lock:
                self._streams.add(op)
            return fn(worksize)
        return call

    def _op_call(self, op, fn):
        """An op call outside a worksize runs to its end inside the call."""
        def call(*args):
            with self._stats_lock:
                sync = op not in self._streams
                self._sync_calls[op] += sync
            try:
                if sync:
                    self._raise_fault()
                return fn(*args)
            finally:
                if sync:
                    with self._stats_lock:
                        self._sync_calls[op] -= 1
                    self._raise_fault()
        return call

    def _completed(self, op, fn):
        def call():
            try:
                return fn()
            finally:
                with self._stats_lock:
                    self._streams.discard(op)
                self._raise_fault()
        return call

    def _raise_fault(self):
        f = self._fault
        if f is not None:
            raise BackendError(
                f"the torch backend failed ({f['abi']}, {f['op']}, shape "
                f"{f['shape']}): {f['error']}; the C++ runtime reran the batch "
                "on its native CPU path.  Register the backend again, or clear "
                f"it, to go on.\n{f['traceback']}")

    # ------------------------------------------------------------- API ----

    def acquire(self):
        self.lib.hexl_tpu_acquire()

    def release(self):
        self.lib.hexl_tpu_release()
        self._registered = False  # the pool took its tables with it

    def dyadic_multiply(self, op1, op2, n, moduli, worksize_batch=None):
        """One or more dyadic multiplies; returns [3][n_moduli][n] array(s)."""
        moduli = np.ascontiguousarray(moduli, dtype=np.uint64)
        n_moduli = len(moduli)
        ops1 = op1 if isinstance(op1, list) else [op1]
        ops2 = op2 if isinstance(op2, list) else [op2]
        outs = [np.zeros(3 * n_moduli * n, dtype=np.uint64) for _ in ops1]
        self.lib.hexl_tpu_set_worksize_dyadic_multiply(len(ops1))
        keep = []
        for a, b, o in zip(ops1, ops2, outs):
            a = np.ascontiguousarray(a, dtype=np.uint64)
            b = np.ascontiguousarray(b, dtype=np.uint64)
            keep += [a, b]
            self.lib.hexl_tpu_dyadic_multiply(
                _np_ptr(o), _np_ptr(a), _np_ptr(b), n, _np_ptr(moduli), n_moduli
            )
        self.lib.hexl_tpu_dyadic_multiply_completed()
        return outs if isinstance(op1, list) else outs[0]

    def keyswitch(self, result, t_target, n, L, K, rns, comp, moduli,
                  k_switch_keys, modswitch_factors, twiddle_factors=None):
        result = np.ascontiguousarray(result, dtype=np.uint64).copy()
        t_target = np.ascontiguousarray(t_target, dtype=np.uint64)
        moduli = np.ascontiguousarray(moduli, dtype=np.uint64)
        msf = np.ascontiguousarray(modswitch_factors, dtype=np.uint64)
        keys = [np.ascontiguousarray(k, dtype=np.uint64) for k in k_switch_keys]
        key_arr = (u64_p * len(keys))(*[_np_ptr(k) for k in keys])
        tw = (
            np.ascontiguousarray(twiddle_factors, dtype=np.uint64)
            if twiddle_factors is not None
            else None
        )
        self.lib.hexl_tpu_set_worksize_keyswitch(1)
        self.lib.hexl_tpu_keyswitch(
            _np_ptr(result), _np_ptr(t_target), n, L, K, rns, comp,
            _np_ptr(moduli), key_arr, _np_ptr(msf),
            _np_ptr(tw) if tw is not None else None,
        )
        self.lib.hexl_tpu_keyswitch_completed()
        return result

    def ntt(self, operand, roots, precon, q, n):
        operand = np.ascontiguousarray(operand, dtype=np.uint64).copy()
        roots = np.ascontiguousarray(roots, dtype=np.uint64)
        precon = np.ascontiguousarray(precon, dtype=np.uint64)
        self.lib.hexl_tpu_set_worksize_ntt(1)
        self.lib.hexl_tpu_ntt(_np_ptr(operand), _np_ptr(roots), _np_ptr(precon), q, n)
        self.lib.hexl_tpu_ntt_completed()
        return operand

    def intt(self, operand, inv_roots, precon, q, inv_n, inv_n_w, n):
        operand = np.ascontiguousarray(operand, dtype=np.uint64).copy()
        inv_roots = np.ascontiguousarray(inv_roots, dtype=np.uint64)
        precon = np.ascontiguousarray(precon, dtype=np.uint64)
        self.lib.hexl_tpu_set_worksize_intt(1)
        self.lib.hexl_tpu_intt(
            _np_ptr(operand), _np_ptr(inv_roots), _np_ptr(precon), q,
            inv_n, inv_n_w, n,
        )
        self.lib.hexl_tpu_intt_completed()
        return operand

    def make_ntt_tables(self, n, q):
        fwd = np.zeros(n, dtype=np.uint64)
        fwd_p = np.zeros(n, dtype=np.uint64)
        inv = np.zeros(n, dtype=np.uint64)
        inv_p = np.zeros(n, dtype=np.uint64)
        inv_n = ctypes.c_uint64()
        inv_n_w = ctypes.c_uint64()
        self.lib.hexl_tpu_make_ntt_tables(
            n, q, _np_ptr(fwd), _np_ptr(fwd_p), _np_ptr(inv), _np_ptr(inv_p),
            ctypes.byref(inv_n), ctypes.byref(inv_n_w),
        )
        return fwd, fwd_p, inv, inv_p, inv_n.value, inv_n_w.value

    # ----------------------------------------------- accelerator backend --

    def register_torch_backend(self, pipelined: bool = True, device=None):
        """Install the port's torch executors as the C++ runtime's
        accelerator backend, on `device` (None: the card; without a CUDA
        device that raises: there is no CPU fallback; "cpu" runs the
        kernels' plain versions).

        Callbacks run on C++ worker threads (ctypes takes the GIL).  Each
        turns its op structs into the port's work items (numpy views over
        the caller's pointers) and hands them to one `TorchExecutor` per
        worker thread, worker k on device index k % device_count: the
        staging, copy stream, pinned copy back and scatter of the Python
        API.  KeySwitch goes through `keyswitch_cuda.get_context` and
        `dispatch_batch`; `_NTT` / `_INTT` use the caller's tables as given.

        With ``pipelined`` (default) the split submit/finalize ABI v2 is
        registered, and no v1 table: submit stages and launches, finalize
        waits for the copy back and scatters, so the C++ scheduler stages
        batch i+1 while batch i computes.  A finalize writes the caller's
        buffers only after the copy's event has completed, and its scatter
        checks every buffer before the first write, so one that fails leaves
        every result untouched (the ABI's contract; KeySwitch accumulates
        into `result`).  Without it only v1 is registered (submit, then
        finalize at once).

        On the card the kernels are built and an executor is made first,
        so that a machine that cannot run them fails here, before any table
        is installed.

        A batch is declined (the callback returns 0 and the C++ runtime
        runs it natively) only for a shape no route of the port serves,
        named before anything launches:
          * `_NTT` / `_INTT`: n not a power of two in [4, 32768], or a
            modulus outside (2, 2^62) (`ntt_cuda._check_n_q`); `_INTT`:
            n^-1 or n^-1 w not a residue below q;
          * DyadicMultiply: no modulus, a modulus below 2
            (`dyadic_cuda.moduli_meta`), more than 65535 ops in the batch
            or more than 65535 moduli (`dyadic_cuda._check`);
          * KeySwitch: key_component_count other than 2, a special modulus
            that is a decomp modulus (K <= L), n not a transform size, a
            modulus outside (2, 2^62).
        Every decline (op, shape, reason) and every exception in a callback
        (with its traceback) is recorded; `backend_stats()` shows them with
        the batches served.  An exception also returns 0 (the ABI has no
        other answer), and is a fault of this runtime (see the class): the
        caller's calls raise, or, for a C++ caller, the process aborts.
        Nothing is retried: only one table is installed, v2 or v1, so a
        batch v2 declines goes straight to the native path."""
        dev = torch.device("cuda" if device is None else device)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"register_torch_backend: device {dev} is neither "
                             "the card ('cuda') nor the CPU")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "register_torch_backend: no CUDA device is available; pass "
                "device='cpu' to run the kernels' plain versions"
            )
        if dev.type == "cuda":
            ntt_cuda.build_kernels()  # KeySwitch's and the transforms'
            dyadic_cuda.build_kernels()
            if keyswitch_cuda.KeySwitchContext.wire_pack_enabled():
                _native.codec_library()
            executors.TorchExecutor(dev.index or 0, force_cpu=False)
        self.clear_backend()
        backend = _TorchBackend(dev, self._record)
        if pipelined:
            v2 = BackendV2(
                submit_dyadic_batch=DYADIC_SUBMIT_CB(backend.submit_dyadic),
                submit_keyswitch_batch=KEYSWITCH_SUBMIT_CB(backend.submit_keyswitch),
                submit_ntt_batch=NTT_SUBMIT_CB(backend.submit_ntt),
                finalize_batch=FINALIZE_CB(backend.finalize),
                ctx=None,
            )
            self._keepalive.append(v2)  # callbacks must outlive the runtime
            self.lib.hexl_tpu_register_backend_v2(ctypes.byref(v2))
        else:
            v1 = BackendV1(
                run_dyadic_batch=DYADIC_CB(backend.run_dyadic),
                run_keyswitch_batch=KEYSWITCH_CB(backend.run_keyswitch),
                run_ntt_batch=NTT_CB(backend.run_ntt),
                ctx=None,
            )
            self._keepalive.append(v1)
            self.lib.hexl_tpu_register_backend(ctypes.byref(v1))
        self._registered = True

    def clear_backend(self):
        """Remove both tables, and with them any fault that stood."""
        self.lib.hexl_tpu_register_backend(None)
        self.lib.hexl_tpu_register_backend_v2(None)
        self._registered = False
        self._fault = None

    def _clear_at_exit(self):
        """At interpreter exit, before the callbacks are freed: a C++ worker
        that outlives Python must find no table of ours to call.  A pool
        already released is not made again for it."""
        if self._registered:
            self.clear_backend()

    def _record(self, kind: str, entry) -> None:
        """Called by the callbacks, on the C++ worker's thread.  An error is
        the runtime's fault; see the class."""
        with self._stats_lock:
            if kind == "served":
                abi, op, count = entry
                for key, v in (("batches", 1), ("ops", count)):
                    per = self._stats[key].setdefault(abi, {})
                    per[op] = per.get(op, 0) + v
                self._stats["threads"].add(threading.get_ident())
                return
            self._stats[kind].append(entry)
            if kind != "errors":
                return
            if self._fault is None:
                self._fault = entry
            ops = _API_STEMS if entry["op"] is None else (entry["op"],)
            if any(op in self._streams or self._sync_calls[op] for op in ops):
                return
        sys.stderr.write(
            "hexl_fpga_tpu_torch.cpp_bridge: the torch backend failed for a "
            f"C++ caller ({entry['abi']}, {entry['op']}, shape {entry['shape']}); "
            f"aborting\n{entry['traceback']}")
        sys.stderr.flush()
        os.abort()

    def backend_stats(self, clear: bool = False) -> dict:
        """What the registered backends did: `batches` and `ops` served by
        ABI version ("v1", "v2") and op, `threads` (how many C++ worker
        threads served them), `declines` (abi, op, shape, reason) and
        `errors` (abi, op, shape, error, traceback).  `clear` starts the
        counts again."""
        with self._stats_lock:
            s = self._stats
            out = {"batches": {a: dict(v) for a, v in s["batches"].items()},
                   "ops": {a: dict(v) for a, v in s["ops"].items()},
                   "threads": len(s["threads"]),
                   "declines": list(s["declines"]), "errors": list(s["errors"])}
            if clear:
                self._stats = _empty_stats()
        return out


def _empty_stats() -> dict:
    return {"batches": {}, "ops": {}, "threads": set(), "declines": [],
            "errors": []}


class _Declined(Exception):
    """A shape no route of the port serves: the reason, and the shape."""

    def __init__(self, reason: str, shape: dict):
        super().__init__(reason)
        self.shape = shape


def _ntt_gate(shape, n: int, q: int, inv_n=None, inv_n_w=None) -> None:
    try:
        ntt_cuda._check_n_q(n, q)
    except ValueError as e:
        raise _Declined(str(e), shape) from None
    if inv_n is not None and not (inv_n < q and inv_n_w < q):
        raise _Declined("inv_n and inv_n_w must be residues below q", shape)


# the buffers an op writes and those its submit reads (snapshots), by arg key
_WRITES = {sched.DYADIC_MULTIPLY: ("results",), sched.KEYSWITCH: ("result",),
           sched.NTT: ("operand",), sched.INTT: ("operand",)}
_READS = {sched.DYADIC_MULTIPLY: ("operand1", "operand2"),
          sched.KEYSWITCH: ("result", "t_target"),
          sched.NTT: ("operand",), sched.INTT: ("operand",)}


def _spans(batch, keys) -> np.ndarray:
    """(B, len(keys), 2) byte ranges [lo, hi) of each item's buffers."""
    lo = np.array([[item.args[k].ctypes.data for k in keys] for item in batch],
                  dtype=np.uint64)
    size = np.array([[item.args[k].nbytes for k in keys] for item in batch],
                    dtype=np.uint64)
    return np.stack([lo, lo + size], axis=-1)


def _alias_runs(batch) -> list:
    """The batch cut where an op reads a buffer an earlier op of its piece
    writes.  The C++ scheduler keeps such ops apart only across batches
    (`runtime.cpp` HasRawHazard), and its native path runs a batch's ops in
    order, so two KeySwitch ops accumulating into one result in one batch
    must see each other's writes here too."""
    op = batch[0].op_type
    reads, writes = _spans(batch, _READS[op]), _spans(batch, _WRITES[op])
    # hit[j, i]: a read of op j overlaps a write of op i
    hit = ((reads[:, None, :, None, 0] < writes[None, :, None, :, 1])
           & (writes[None, :, None, :, 0] < reads[:, None, :, None, 1])
           ).any(axis=(2, 3))
    if not np.tril(hit, -1).any():
        return [batch]
    runs, start = [], 0
    for j in range(1, len(batch)):
        if hit[j, start:j].any():
            runs.append(batch[start:j])
            start = j
    return runs + [batch[start:]]


def _in_order(submit, batch):
    """submit(batch)'s finalize.  A batch whose ops alias runs as its
    consecutive pieces (_alias_runs), each but the last finalized here,
    before the next stages its inputs.  A piece that fails puts the caller's
    buffers back first: a failed batch leaves them untouched, as the ABI
    requires of a batch the native path reruns."""
    *first, last = _alias_runs(batch)
    if not first:
        return submit(last)
    keys = _WRITES[batch[0].op_type]
    saved = [(a, a.copy()) for item in batch for a in (item.args[k] for k in keys)]

    def restore():
        for a, copy in saved:
            np.copyto(a, copy)

    try:
        for run in first:
            submit(run)()
        fin = submit(last)
    except BaseException:
        restore()
        raise

    def finalize():
        try:
            fin()
        except BaseException:
            restore()
            raise

    return finalize


class _TorchBackend:
    """The callbacks of one registration and their state: one executor per
    calling C++ worker thread, the numpy views of each key set (one per
    tuple of key pointers, so the context's key cache, keyed by array
    identity, uploads a key set once and not once per batch), and the v2
    batches in flight by handle."""

    # as many key sets as a KeySwitch context keeps on the card
    KEY_VIEW_SLOTS = 8

    def __init__(self, device: torch.device, record):
        self.device = device
        self.record = record
        self._lock = threading.Lock()
        # by OS thread id: a ctypes callback on a foreign thread runs under a
        # thread state made and dropped per call, so a threading.local would
        # not outlive one callback
        self._executors: dict = {}
        self._key_views: OrderedDict = OrderedDict()
        self._pending: dict = {}
        self._handles = itertools.count(1)

    def _executor(self) -> "executors.TorchExecutor":
        tid = threading.get_ident()
        with self._lock:
            ex = self._executors.get(tid)
            if ex is None:
                index = (self.device.index or 0) + len(self._executors)
                ex = executors.TorchExecutor(
                    index, force_cpu=self.device.type == "cpu")
                self._executors[tid] = ex
        ex.bind_thread()
        return ex

    # -- op structs -> work items ---------------------------------------------

    def _dyadic_batch(self, ops, count):
        o = ops[0]
        n, M = int(o.n), int(o.n_moduli)
        shape = {"count": count, "n": n, "n_moduli": M}
        if M < 1 or count > 65535 or M > 65535:
            raise _Declined("DyadicMultiply: 1 .. 65535 moduli and at most "
                            "65535 ops a batch", shape)
        moduli = _view(o.moduli, M).copy()
        try:
            dyadic_cuda.moduli_meta(moduli)
        except ValueError as e:
            raise _Declined(str(e), shape) from None
        batch = [sched.WorkItem(sched.DYADIC_MULTIPLY, {
            "results": _view(ops[i].results, 3 * M * n),
            "operand1": _view(ops[i].operand1, 2 * M * n),
            "operand2": _view(ops[i].operand2, 2 * M * n),
            "n": n, "moduli": moduli, "n_moduli": M,
        }) for i in range(count)]
        return batch, shape

    def _ntt_batch(self, ops, count, inverse):
        o = ops[0]
        n, q = int(o.n), int(o.coeff_modulus)
        op = sched.INTT if inverse else sched.NTT
        shape = {"count": count, "n": n, "q": q}
        if inverse:
            _ntt_gate(shape, n, q, int(o.inv_n), int(o.inv_n_w))
        else:
            _ntt_gate(shape, n, q)
        roots = "inv_root_of_unity_powers" if inverse else "root_of_unity_powers"
        shared = {roots: _view(o.root_powers, n),
                  "precon": _view(o.precon_root_powers, n),
                  "coeff_modulus": q, "n": n}
        if inverse:
            shared.update(inv_n=int(o.inv_n), inv_n_w=int(o.inv_n_w))
        batch = [sched.WorkItem(op, {"operand": _view(ops[i].operand, n), **shared})
                 for i in range(count)]
        return batch, shape

    def _keys(self, ptrs, L: int, size: int):
        """The numpy views of one key set, the same objects for the same
        pointers (LRU of KEY_VIEW_SLOTS): the key cache then sees one array
        set per key set and checks its sampled checksum on each hit, which
        still guards the content."""
        kid = (tuple(_address(ptrs[i]) for i in range(L)), size)
        with self._lock:
            views = self._key_views.get(kid)
            if views is None:
                views = [_view(ptrs[i], size) for i in range(L)]
                self._key_views[kid] = views
                while len(self._key_views) > self.KEY_VIEW_SLOTS:
                    self._key_views.popitem(last=False)
            else:
                self._key_views.move_to_end(kid)
        return views

    def _keyswitch_batch(self, ops, count):
        o = ops[0]
        n, L, K = int(o.n), int(o.decomp_modulus_size), int(o.key_modulus_size)
        comp = int(o.key_component_count)
        shape = {"count": count, "n": n, "L": L, "K": K, "comp": comp}
        if comp != 2:
            raise _Declined("KeySwitch: key_component_count must be 2", shape)
        if K < L + 1:
            raise _Declined("KeySwitch: the special modulus must not be a "
                            "decomp modulus (K > L)", shape)
        moduli = _view(o.moduli, K).copy()
        for q in moduli:
            _ntt_gate(shape, n, int(q))
        tw = _view(o.twiddle_factors, K * 4 * n).copy() if o.twiddle_factors else None
        shared = {
            "n": n, "decomp_modulus_size": L, "key_modulus_size": K,
            "rns_modulus_size": int(o.rns_modulus_size),
            "key_component_count": comp, "moduli": moduli,
            "k_switch_keys": self._keys(o.k_switch_keys, L, comp * K * n),
            "modswitch_factors": _view(o.modswitch_factors, K).copy(),
            "twiddle_factors": tw, "plain_modulus": None,
        }
        batch = [sched.WorkItem(sched.KEYSWITCH, {
            "result": _view(ops[i].result, comp * L * n),
            "t_target": _view(ops[i].t_target, L * n), **shared,
        }) for i in range(count)]
        return batch, shape

    # -- the two ABIs ------------------------------------------------------------

    def _submit(self, abi, op, make):
        """(batch, shape) = make(); the executor's submit (_in_order);
        returns its finalize, or None after recording a decline or an
        error."""
        shape = None
        try:
            batch, shape = make()
            fin = _in_order(getattr(self._executor(), f"submit_{op.lower()}"), batch)
        except _Declined as e:
            self.record("declines", {"abi": abi, "op": op, "shape": e.shape,
                                     "reason": str(e)})
            return None
        except Exception as e:
            self._error(abi, op, shape, e)
            return None
        return fin, len(batch), shape

    def _error(self, abi, op, shape, exc):
        self.record("errors", {"abi": abi, "op": op, "shape": shape,
                               "error": repr(exc),
                               "traceback": "".join(traceback.format_exception(exc))})

    def _run(self, op, make) -> int:
        """v1: submit, then finalize at once."""
        sub = self._submit("v1", op, make)
        if sub is None:
            return 0
        fin, count, shape = sub
        try:
            fin()
        except Exception as e:
            self._error("v1", op, shape, e)
            return 0
        self.record("served", ("v1", op, count))
        return 1

    def _register(self, op, make) -> int:
        """v2 submit: the finalize is kept under a nonzero handle."""
        sub = self._submit("v2", op, make)
        if sub is None:
            return 0
        h = next(self._handles)
        with self._lock:
            self._pending[h] = (op, *sub)
        return h

    def run_dyadic(self, ctx, ops, count):
        return self._run(sched.DYADIC_MULTIPLY, lambda: self._dyadic_batch(ops, count))

    def run_keyswitch(self, ctx, ops, count):
        return self._run(sched.KEYSWITCH, lambda: self._keyswitch_batch(ops, count))

    def run_ntt(self, ctx, ops, count, inverse):
        op = sched.INTT if inverse else sched.NTT
        return self._run(op, lambda: self._ntt_batch(ops, count, inverse))

    def submit_dyadic(self, ctx, ops, count):
        return self._register(sched.DYADIC_MULTIPLY,
                              lambda: self._dyadic_batch(ops, count))

    def submit_keyswitch(self, ctx, ops, count):
        return self._register(sched.KEYSWITCH,
                              lambda: self._keyswitch_batch(ops, count))

    def submit_ntt(self, ctx, ops, count, inverse):
        op = sched.INTT if inverse else sched.NTT
        return self._register(op, lambda: self._ntt_batch(ops, count, inverse))

    def finalize(self, ctx, handle):
        with self._lock:
            entry = self._pending.pop(int(handle), None)
        if entry is None:
            self._error("v2", None, None, KeyError(f"no batch in flight under "
                                                   f"handle {int(handle)}"))
            return 0
        op, fin, count, shape = entry
        try:
            self._executor()  # binds this thread's device
            fin()
        except Exception as e:
            self._error("v2", op, shape, e)
            return 0
        self.record("served", ("v2", op, count))
        return 1
