#!/usr/bin/env python3
"""The SASS of the rect kernel's instantiations (``csrc/rect_ncc.cu``; the
default, 9-tap and runtime-bounds builds of each variant): instruction
counts, the tap loops, and which instantiations are identical across
trees.

    python scripts/sass_rect_ncc.py [ROOT ...]

Builds the kernel library of each ``ROOT`` (default: this checkout; a
parent unpacked beside it can be given too) through its own ``_lib``, in a
process of its own, and disassembles it with ``cuobjdump -sass``.  Per
``rect_ncc_kernel`` instantiation it prints the instruction count and each
tap loop: the innermost backward branch whose body holds global loads,
with its instructions, its global loads, and its instructions per
(candidate, pixel, tap) -- the body over its taps, where an f32
instantiation loads two floats per tap and a packed one one pair word (two
floats in a tree without ``pack_src_pairs``, whose packed loop rounded
each loaded value).  With
several roots it prints, per instantiation, whether its instructions (the
addresses stripped) are the same in every tree.  One JSON line.  Needs
``nvcc`` and ``cuobjdump`` (the CUDA toolkit), not a GPU.
"""

from __future__ import annotations

import json
import pathlib
import re
import shutil
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
from acmmp_spherical_torch.ops.kernels.ncc_rect import TAP_BUILDS  # noqa: E402

BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "from acmmp_spherical_torch.ops.kernels import _lib, ncc_rect; "
         "print(hasattr(ncc_rect, 'pack_src_pairs')); "
         "print(_lib.library()._name)")
FUNC = re.compile(r"Function : (\S+)")
INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
KERNEL = re.compile(r"rect_ncc_kernelILb(\d)ELb(\d)ELi(\d+)E")


def _variant(mangled: str):
    m = KERNEL.search(mangled)
    if m is None:
        return None
    return (("geom" if m.group(1) == "1" else "phot")
            + ("_pk" if m.group(2) == "1" else "")
            + TAP_BUILDS[m.group(3)])


def _functions(lib: str) -> dict:
    """{variant: [(address, instruction)]} of the rect kernel."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = FUNC.search(line)
        if m:
            cur = _variant(m.group(1))
            if cur is not None:
                out[cur] = []
            continue
        m = INSTR.search(line)
        if m and cur is not None:
            out[cur].append((int(m.group(1), 16), m.group(2)))
    return out


def _tap_loops(instrs, loads_per_tap: int):
    """The innermost loops that load from global memory: per loop its
    instructions, global loads and instructions per (candidate, pixel,
    tap)."""
    index = {addr: i for i, (addr, _) in enumerate(instrs)}
    loops = []
    for i, (addr, ins) in enumerate(instrs):
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
        if not m or int(m.group(1), 16) >= addr:
            continue
        start = index.get(int(m.group(1), 16))
        if start is None:
            continue
        body = [b for _, b in instrs[start:i + 1]]
        loads = sum(1 for b in body if re.search(r"\bLDG\b", b))
        if loads:
            loops.append((start, i, body, loads))
    inner = [lp for lp in loops if not any(
        o[0] >= lp[0] and o[1] <= lp[1] and o is not lp for o in loops)]
    res = []
    for _, _, body, loads in inner:
        taps = loads / loads_per_tap
        res.append(dict(instructions=len(body), global_loads=loads,
                        per_tap=len(body) / taps))
    return res


def main() -> int:
    roots = [pathlib.Path(r).resolve() for r in (sys.argv[1:] or [HERE])]
    trees, pair_frame = {}, {}
    for root in roots:
        pairs, lib = subprocess.run(
            [sys.executable, "-c", BUILD, str(root)], capture_output=True,
            text=True, check=True).stdout.strip().splitlines()[-2:]
        trees[str(root)] = _functions(lib)
        pair_frame[str(root)] = pairs == "True"
    out = {}
    for root, funcs in trees.items():
        out[root] = {v: dict(instructions=len(ins), tap_loops=_tap_loops(
            ins, 1 if "_pk" in v and pair_frame[root] else 2))
            for v, ins in sorted(funcs.items())}
    if len(trees) > 1:
        first, *rest = trees.values()
        out["identical"] = {
            v: all(v in t and [b for _, b in t[v]] == [b for _, b in ins]
                   for t in rest) for v, ins in sorted(first.items())}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
