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

from ..ops import dyadic_cuda, golden, keyswitch_cuda, ntt_cuda, word64 as w
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


class TorchExecutor(_Base):
    """torch backend (RUN_CHOICE=1 on the CPU, =2 on CUDA)."""

    def __init__(self, device_index: int, force_cpu: bool):
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

    def bind_thread(self) -> None:
        """Make this executor's device the calling thread's current one."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def submit_dyadic_multiply(self, batch):
        # fences keep a batch to one (n, n_moduli, moduli); one kernel serves
        # every n and every moduli vector, the ramp tests' tiny composite
        # moduli at n = 64 included
        a = batch[0].args
        n, M = a["n"], a["n_moduli"]
        runner = dyadic_cuda.runner(np.asarray(a["moduli"])[:M], self.device)
        op1, op2 = (
            w.from_u64_np(
                np.stack([np.asarray(i.args[key], dtype=np.uint64).reshape(2, M, n)
                          for i in batch]),
                self.device,
            )
            for key in ("operand1", "operand2")
        )
        out = runner.run(op1, op2)

        def finalize():
            # the blocking device->host copy
            host = w.to_u64_np(out).reshape(len(batch), -1)
            for b, item in enumerate(batch):
                np.copyto(item.args["results"],
                          host[b].reshape(item.args["results"].shape))

        return finalize

    def run_dyadic_multiply(self, batch):
        self.submit_dyadic_multiply(batch)()

    def _submit_transform(self, batch, transform, tabs):
        """Shared submit/finalize split of the worksize-batched `_NTT` /
        `_INTT` streams: stack the operands, launch, and leave the copy back
        into the caller's operand buffers (in place) to finalize."""
        x = w.from_u64_np(
            np.stack([np.asarray(i.args["operand"], dtype=np.uint64) for i in batch]),
            self.device,
        )
        out = transform(x, tabs)

        def finalize():
            host = w.to_u64_np(out)
            for b, item in enumerate(batch):
                np.copyto(item.args["operand"], host[b])

        return finalize

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
        ts = np.stack(
            [np.asarray(i.args["t_target"], dtype=np.uint64).ravel() for i in batch]
        )
        rs = np.stack(
            [np.asarray(i.args["result"], dtype=np.uint64).ravel() for i in batch]
        )
        out = ctx.dispatch_batch(
            rs, ts, a["k_switch_keys"], a["modswitch_factors"]
        )

        def finalize():
            # the blocking device->host copy
            host = w.to_u64_np(out).reshape(len(batch), -1)
            for b, item in enumerate(batch):
                np.copyto(item.args["result"],
                          host[b].reshape(item.args["result"].shape))

        return finalize

    def run_keyswitch(self, batch):
        self.submit_keyswitch(batch)()
