"""Count the machine instructions of the split kernels' register passes.

    python -m hexl_fpga_tpu_torch.utils.sass_count [SASS_FILE]

Without an argument it builds the NTT kernels (nvcc) and disassembles the
library with the toolkit's `cuobjdump -sass`; with one it reads a saved
disassembly.  For each kernel it finds the loops whose body reads and writes
shared memory 2^r times each (one sub-network of a register pass,
csrc/ntt_kernels.cuh fwd_pass / inv_pass; r = SPLIT_R gives 12 butterflies)
and prints one JSON object per line: the loop's instructions, those per
butterfly, and per butterfly by class (32-bit multiply-adds IMAD*, other
integer ALU, compares and selects, memory, the rest).  The bound of the
transforms counts 10 multiply-adds a butterfly (chip_smoke.py
IMAD_LAZY_MUL); this is what the compiler made of one.
"""

from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys

from hexl_fpga_tpu_torch.ops import _build, ntt_cuda

R = ntt_cuda.SPLIT_R
BUTTERFLIES = R << (R - 1)  # r stages of 2^(r-1) butterflies
CLASSES = (("imad", ("IMAD",)),
           ("alu", ("IADD3", "LEA", "SHF", "LOP3", "IADD", "VIADD", "MOV", "IABS")),
           ("compare_select", ("ISETP", "SEL", "PLOP3")),
           ("memory", ("LDS", "STS", "LDG", "STG", "LDC", "ULDC", "LD", "ST")))


def disassemble() -> str:
    ntt_cuda.build_kernels()
    lib = _build.build(ntt_cuda.KERNEL_SOURCE, ntt_cuda.KERNEL_DEPS)
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout


def functions(sass: str) -> dict:
    """{mangled kernel name: [(address, opcode), ...]}"""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            op = re.sub(r"^@!?U?P\w+\s+", "", m.group(2)).split()[0]
            cur.append((int(m.group(1), 16), op, m.group(2)))
    return out


def loops(body):
    """(start, end) address pairs of backward branches: one loop each."""
    for addr, op, text in body:
        m = re.match(r"BRA\s+(0x[0-9a-f]+)", re.sub(r"^@!?U?P\w+\s+", "", text))
        if op == "BRA" and m and int(m.group(1), 16) < addr:
            yield int(m.group(1), 16), addr


def classify(op: str) -> str:
    base = op.split(".")[0]
    for name, prefixes in CLASSES:
        if base in prefixes:
            return name
    return "other"


def passes(body):
    """The register-pass loops of one kernel: bodies with 2^R shared-memory
    reads and writes and no inner loop."""
    bounds = list(loops(body))
    for start, end in bounds:
        if any(start < s and e <= end for s, e in bounds if (s, e) != (start, end)):
            continue
        ops = [op for a, op, _ in body if start <= a <= end]
        lds = sum(o.startswith("LDS") for o in ops)
        sts = sum(o.startswith("STS") for o in ops)
        if lds == 1 << R and sts == 1 << R:
            yield start, ops


def main(argv) -> int:
    sass = open(argv[1]).read() if len(argv) > 1 else disassemble()
    for name, body in sorted(functions(sass).items()):
        for start, ops in passes(body):
            by = collections.Counter(classify(o) for o in ops)
            print(json.dumps({
                "kernel": name, "loop_at": hex(start), "instructions": len(ops),
                "butterflies": BUTTERFLIES,
                "per_butterfly": len(ops) / BUTTERFLIES,
                "per_butterfly_by_class": {k: by[k] / BUTTERFLIES for k in
                                           ("imad", "alu", "compare_select",
                                            "memory", "other")},
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
