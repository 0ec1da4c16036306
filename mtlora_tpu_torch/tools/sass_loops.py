"""Issued instructions of a kernel's loops, from its SASS:

    python -m mtlora_tpu_torch.tools.sass_loops SOURCE KERNEL

Compiles ``ops/csrc/SOURCE`` alone for sm_90a into a cubin (the build's
``nvcc`` flags, under ``build/``), disassembles it with ``cuobjdump
-sass`` and prints one JSON line for each loop of each instance of
KERNEL (a substring of the mangled name): a loop is a backward branch
and the instructions from its target to itself; the line gives their
count and their count by opcode. Runs where the CUDA toolkit is, the
card's machine.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess

from mtlora_tpu_torch.ops import _build

FUNCTION = re.compile(r"Function : (\S+)")
INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")
TARGET = re.compile(r"0x([0-9a-f]+)")


def loops(sass: str, kernel: str) -> list:
    """``[{"kernel", "start", "end", "instructions", "opcodes"}]``: every
    backward branch of every function whose name holds ``kernel``."""
    out, name, body = [], None, []

    def close():
        if name is None or kernel not in name:
            return
        for addr, op, args in body:
            if not op.startswith("BRA"):
                continue
            m = TARGET.search(args)
            if m is None or int(m[1], 16) >= addr:
                continue
            start = int(m[1], 16)
            ops = collections.Counter(o.split(".")[0] for a, o, _ in body
                                      if start <= a <= addr)
            out.append({"kernel": name, "start": hex(start),
                        "end": hex(addr), "instructions": sum(ops.values()),
                        "opcodes": dict(ops.most_common())})

    for line in sass.splitlines():
        m = FUNCTION.search(line)
        if m:
            close()
            name, body = m[1], []
            continue
        m = INSTR.search(line)
        if m:
            body.append((int(m[1], 16), m[3], m[4]))
    close()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", help="a file of ops/csrc, e.g. adapter_mlp_fwd.cu")
    ap.add_argument("kernel", help="a substring of the kernel's mangled name")
    a = ap.parse_args(argv)
    nvcc = _build._nvcc()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cubin = _build.BUILD_DIR / f"{a.source}.{os.getpid()}.cubin"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin),
                    str(_build.CSRC / a.source)], check=True,
                   capture_output=True, text=True)
    sass = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
         str(cubin)], check=True, capture_output=True, text=True).stdout
    cubin.unlink()
    found = loops(sass, a.kernel)
    if not found:
        raise SystemExit(f"sass_loops: no loop of {a.kernel} in {a.source}")
    for rec in found:
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
