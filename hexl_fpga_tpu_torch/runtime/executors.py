"""Batch executors: route work batches to a compute backend.

The RUN_CHOICE dispatch of the reference (`host/src/fpga_int.cpp:40-64,
195-207,464-482`):
  0 -> CPU golden model (the Intel-HEXL fallback; NTT/INTT unsupported there,
       as in the reference which aborts: `fpga_int.cpp:317-321`),
  1 -> emulation: the torch path on device="cpu" (plain versions of the kernels),
  2 -> accelerated: the torch path on CUDA; no CUDA device is an error.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..ops import dyadic_cuda, golden, keyswitch_cuda, ntt_cuda, wirepack, word64 as w
from . import scheduler as sched


def make_executor(run_choice: int, device_index: int):
    if run_choice == 0:
        return GoldenExecutor()
    return TorchExecutor(device_index, force_cpu=(run_choice == 1))


class _Base:
    def run_batch(self, batch: List["sched.WorkItem"]) -> None:
        op = batch[0].op_type
        getattr(self, f"run_{op.lower()}")(batch)

    def submit(self, batch: List["sched.WorkItem"]):
        """Dispatch a batch without blocking on results.

        Returns a finalize callable that demultiplexes results into the
        caller buffers (or None if the op ran synchronously).  The worker
        overlaps finalize of batch i-1 with device compute of batch i —
        the reference's ping-pong read of the previous batch's output
        (`host/src/fpga.cpp:1517-1545`)."""
        op = batch[0].op_type
        fn = getattr(self, f"submit_{op.lower()}", None)
        if fn is None:
            self.run_batch(batch)
            return None
        return fn(batch)


class GoldenExecutor(_Base):
    """CPU golden-model backend (RUN_CHOICE=0)."""

    def run_dyadic_multiply(self, batch):
        for item in batch:
            a = item.args
            out = golden.dyadic_multiply(
                a["operand1"], a["operand2"], a["n"], a["moduli"], a["n_moduli"]
            )
            np.copyto(a["results"], out.reshape(a["results"].shape))

    def run_ntt(self, batch):
        raise RuntimeError(
            "NTT not supported on the CPU backend (RUN_CHOICE=0); the reference "
            "aborts here too (`host/src/fpga_int.cpp:317-321`)"
        )

    run_intt = run_ntt

    def run_keyswitch(self, batch):
        for item in batch:
            a = item.args
            out = golden.keyswitch(
                a["result"],
                a["t_target"],
                a["n"],
                a["decomp_modulus_size"],
                a["key_modulus_size"],
                a["rns_modulus_size"],
                a["key_component_count"],
                a["moduli"],
                a["k_switch_keys"],
                a["modswitch_factors"],
                a["twiddle_factors"],
                plain_modulus=a.get("plain_modulus"),
            )
            np.copyto(a["result"], out.reshape(a["result"].shape))


def _scatter_to(batch, key: str, decode=None):
    """scatter(host): row b of a batch's result into batch[b]'s caller
    buffer args[key], in place.  host is the device result's numpy bytes:
    u64 bit patterns, or whatever `decode` turns into u64 (packed words)."""

    def scatter(host):
        host = host.view(np.uint64) if decode is None else decode(host)
        host = host.reshape(len(batch), -1)
        # every check comes before the first write, so a scatter that raises
        # has written nothing (a failed finalize leaves the caller's buffers
        # as they were): a copy into a writable array of the same shape, of a
        # dtype it may cast to, cannot fail
        pairs = [(item.args[key], host[b].reshape(item.args[key].shape))
                 for b, item in enumerate(batch)]
        for dst, src in pairs:
            if not (dst.flags.writeable
                    and np.can_cast(src.dtype, dst.dtype, "same_kind")):
                raise ValueError(f"scatter: {key} must be a writable buffer "
                                 f"that takes {src.dtype}, got {dst.dtype}")
        for dst, src in pairs:
            np.copyto(dst, src)

    return scatter


class TorchExecutor(_Base):
    """torch backend (RUN_CHOICE=1 on the CPU, =2 on CUDA).

    On CUDA a batch's copies and its body go to two streams, ordered by
    events, so the worker's overlap of finalize(i-1) with batch i happens on
    the card: the upload of batch i goes to this executor's copy stream and
    waits for no body; the body runs on the thread's current (compute)
    stream after the upload's event; the copy back of batch i-1 waits for
    its own body's event alone and runs on the copy stream while body i
    computes.  On the CPU there are no streams.

    A batch's operands are copied from the caller's buffers straight into
    pinned host tensors, so the upload does not hold the worker; torch's
    caching host allocator reuses their blocks once the copies that read
    them have completed."""

    def __init__(self, device_index: int, force_cpu: bool):
        self.copy_stream = None
        if force_cpu:
            self.device = torch.device("cpu")
        elif not torch.cuda.is_available():
            raise RuntimeError(
                "RUN_CHOICE=2 needs a CUDA device and none is available; "
                "set RUN_CHOICE=1 for the same code on the CPU"
            )
        else:
            self.device = torch.device(
                "cuda", device_index % torch.cuda.device_count()
            )
            self.copy_stream = torch.cuda.Stream(self.device)
        # queues the copy back of the last batch submitted (once)
        self._queue_copy_back = lambda: None
        # while a list: each CUDA batch appends its timing events (body
        # start, body end, copy-back start, copy-back end); chip_smoke.py
        # reads the copy-back's overlap with the next body from them
        self.timeline = None

    def bind_thread(self) -> None:
        """Make this executor's device the calling thread's current one."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def _submit_gathered(self, batch, operands, body, scatter):
        """_submit of a batch whose operands, (arg key, row shape) in
        operands, are copied from each item straight into a host tensor of
        (len(batch), *row) int64 values, pinned on CUDA."""
        host = []
        for key, row in operands:
            t = torch.empty((len(batch), *row), dtype=torch.int64,
                            pin_memory=self.device.type == "cuda")
            dst = t.numpy().view(np.uint64)
            for b, item in enumerate(batch):
                np.copyto(dst[b], np.asarray(item.args[key], dtype=np.uint64)
                          .reshape(row))
            host.append(t)

        def stage():
            return tuple(w.from_u64_np(t, self.device) for t in host)

        return self._submit(stage, body, scatter)

    def _submit(self, stage, body, scatter):
        """One batch, split into submit and the returned finalize: stage()
        uploads the batch's host arrays and returns the device tensors,
        body(*tensors) computes the device result, scatter(host) writes the
        result's numpy bytes into the caller's buffers.

        The copy back is queued behind the next batch's upload and ahead of
        its body (or by finalize, whichever comes first): a body is a few
        hundred launches that the card runs as fast as the host enqueues
        them, so a copy queued only once finalize runs, after the next body's
        launches, would find that body all but done.  It goes into pinned
        memory without blocking the host; finalize waits for its event."""
        copy = self.copy_stream
        if copy is None:
            out = body(*stage())
            return lambda: scatter(out.contiguous().numpy())
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(copy):
            staged = stage()
            uploaded = torch.cuda.Event()
            uploaded.record()
        compute.wait_event(uploaded)
        for x in staged:  # freed while the body may still read it
            x.record_stream(compute)
        self._queue_copy_back()  # the previous batch's
        marks = None
        if self.timeline is not None:
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            self.timeline.append(marks)
            marks[0].record(compute)
        out = body(*staged)
        computed = marks[1] if marks else torch.cuda.Event()
        computed.record(compute)
        copied = []  # (host tensor, event behind its copy) once queued

        def queue_copy_back():
            if copied:
                return
            copy.wait_event(computed)
            with torch.cuda.stream(copy):
                if marks:
                    marks[2].record()
                host = w.to_host_async(out)
                done = marks[3] if marks else torch.cuda.Event()
                done.record()
            copied.append((host, done))

        self._queue_copy_back = queue_copy_back

        def finalize():
            queue_copy_back()
            host, done = copied[0]
            # `out` stays referenced (by queue_copy_back) until the copy
            # has landed; then the executor lets it go
            done.synchronize()
            if self._queue_copy_back is queue_copy_back:
                self._queue_copy_back = lambda: None
            scatter(host.numpy())

        return finalize

    def submit_dyadic_multiply(self, batch):
        # fences keep a batch to one (n, n_moduli, moduli); one kernel serves
        # every n and every moduli vector, the ramp tests' tiny composite
        # moduli at n = 64 included
        a = batch[0].args
        n, M = a["n"], a["n_moduli"]
        runner = dyadic_cuda.runner(np.asarray(a["moduli"])[:M], self.device)
        return self._submit_gathered(
            batch, [("operand1", (2, M, n)), ("operand2", (2, M, n))],
            runner.run, _scatter_to(batch, "results"))

    def run_dyadic_multiply(self, batch):
        self.submit_dyadic_multiply(batch)()

    def _submit_transform(self, batch, transform, tabs):
        """Shared submit/finalize split of the worksize-batched `_NTT` /
        `_INTT` streams: gather the operands, launch, and leave the copy back
        into the caller's operand buffers (in place) to finalize."""
        return self._submit_gathered(
            batch, [("operand", np.shape(batch[0].args["operand"]))],
            lambda x: transform(x, tabs), _scatter_to(batch, "operand"))

    def submit_ntt(self, batch):
        # the caller's tables are used as given (cached on the device by
        # content); the fence key is (n, modulus), so a batch shares them
        a = batch[0].args
        tabs = ntt_cuda.caller_fwd_tables(
            a["n"], a["coeff_modulus"], a["root_of_unity_powers"], a["precon"],
            device=self.device,
        )
        return self._submit_transform(batch, ntt_cuda.ntt_fwd, tabs)

    def submit_intt(self, batch):
        a = batch[0].args
        tabs = ntt_cuda.caller_inv_tables(
            a["n"], a["coeff_modulus"], a["inv_root_of_unity_powers"],
            a["precon"], a["inv_n"], a["inv_n_w"], device=self.device,
        )
        return self._submit_transform(batch, ntt_cuda.ntt_inv, tabs)

    def run_ntt(self, batch):
        self.submit_ntt(batch)()

    def run_intt(self, batch):
        self.submit_intt(batch)()

    def submit_keyswitch(self, batch):
        a = batch[0].args
        ctx = keyswitch_cuda.get_context(
            a["n"],
            a["decomp_modulus_size"],
            a["key_modulus_size"],
            a["rns_modulus_size"],
            a["key_component_count"],
            a["moduli"],
            a["twiddle_factors"],
            device=self.device,
            plain_modulus=a.get("plain_modulus"),
        )
        if ctx.wire_pack_enabled():
            # 52-bit words both ways (HEXL_TPU_WIRE_PACK=1): the host packs
            # (the native codec), the copy stream moves packed words, the
            # card unpacks and packs (the reference's dispatch_batch32p route)
            rp, tp = ctx.pack_operands(
                *(np.stack([np.asarray(i.args[key], dtype=np.uint64).ravel()
                            for i in batch]) for key in ("result", "t_target")))

            def stage_packed():
                return (wirepack.to_device(rp, self.device),
                        wirepack.to_device(tp, self.device))

            def body_packed(r, t):
                return ctx.dispatch_batch_packed(
                    r, t, a["k_switch_keys"], a["modswitch_factors"])

            return self._submit(
                stage_packed, body_packed,
                _scatter_to(batch, "result",
                            lambda h: wirepack.unpack_u64_native(h.view(np.uint32))))

        def body(r, t):
            return ctx.dispatch_batch(
                keyswitch_cuda.DeviceCiphertext(r, ctx),
                keyswitch_cuda.DeviceTarget(t, ctx),
                a["k_switch_keys"], a["modswitch_factors"],
            )

        return self._submit_gathered(
            batch,
            [("result", (ctx.comp, ctx.L, ctx.n)), ("t_target", (ctx.L, ctx.n))],
            body, _scatter_to(batch, "result"))

    def run_keyswitch(self, batch):
        self.submit_keyswitch(batch)()
