"""Instruction mix of a kernel's hot loop, read from its SASS.

``hot_loop_mix`` takes ``cuobjdump -sass`` text (``kernels.sass``),
finds the kernel's innermost loop with the most shared-memory loads (the
dense verdict's unrolled entry loop: one ``LDS.128`` per entry, which
feeds each of the thread's packets), drops the blocks that predicated
forward branches inside that loop jump over (the accumulate taken only
on a hit) and counts what remains, the instructions a (packet, entry)
pair issues on the miss path, by execution pipe.

Pipes (Nsight Compute's names; per SM and clock on Hopper): ``alu``,
integer compare, logic, add and select, 64 lanes; ``fma``, IMAD and the
FP32 multiply-adds, of which IMAD runs on the 64-lane heavy half; every
instruction, whatever its pipe, passes the four warp schedulers, one
warp instruction each per clock (128 lanes).  An opcode listed in
neither pipe counts towards the issue rate only, so a misplaced opcode
can only lower the bound built from these counts.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, List, NamedTuple

ALU = frozenset({"ISETP", "PLOP3", "LOP3", "IADD3", "SEL", "SHF", "LEA",
                 "IMNMX", "FSETP", "FSEL", "PRMT", "P2R", "R2P", "FLO",
                 "POPC", "BMSK", "SGXT"})
FMA = frozenset({"IMAD", "IMUL", "FFMA", "FADD", "FMUL"})
# lanes per SM and clock
LANES = {"alu": 64, "fma": 64, "issue": 128}

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:(@!?U?P[T0-9]+)\s+)?"
                   r"([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)\s*([^;]*);")
_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")


class Insn(NamedTuple):
    addr: int
    pred: str
    op: str        # base opcode, e.g. "ISETP"
    full: str      # with modifiers, e.g. "ISETP.NE.AND"
    operands: str


def parse(text: str, kernel: str) -> List[Insn]:
    """The instructions of the first function whose mangled name holds
    ``kernel``."""
    insns: List[Insn] = []
    inside = False
    for line in text.splitlines():
        f = _FUNC.match(line)
        if f:
            if inside:
                break
            inside = kernel in f.group(1)
            continue
        m = _INSN.search(line) if inside else None
        if m:
            insns.append(Insn(int(m.group(1), 16), m.group(2) or "",
                              m.group(3), m.group(3) + m.group(4),
                              m.group(5).strip()))
    if not insns:
        raise ValueError(f"no SASS found for a kernel named *{kernel}*")
    return insns


def _target(insn: Insn) -> int:
    return int(re.search(r"0x([0-9a-f]+)", insn.operands).group(1), 16)


def hot_loop_mix(text: str, kernel: str, packets_per_load: int = 1
                 ) -> Dict:
    """Per-pair instruction counts of ``kernel``'s entry loop on the miss
    path, where each thread compares ``packets_per_load`` packets with
    every entry it loads: {"loop": [head, back edge],
    "pairs_per_iteration", "per_pair": {"alu", "fma", "issue"},
    "opcodes": {op: count per iteration}}."""
    insns = parse(text, kernel)
    back = [i for i in insns if i.op == "BRA" and _target(i) <= i.addr]
    loops = []
    for b in back:
        head = _target(b)
        inner = not any(o is not b and head <= _target(o) <= o.addr <= b.addr
                        for o in back)
        body = [i for i in insns if head <= i.addr <= b.addr]
        lds = sum(i.op == "LDS" for i in body)
        if inner and lds:
            loops.append((lds, head, b.addr, body))
    if not loops:
        raise ValueError(f"{kernel}: no loop with shared-memory loads")
    loads, head, end, body = max(loops, key=lambda x: x[0])
    pairs = loads * packets_per_load
    skipped = [(i.addr, _target(i)) for i in body
               if i.op == "BRA" and i.pred and i.addr < _target(i) <= end]
    hot = [i for i in body
           if not any(lo < i.addr < hi for lo, hi in skipped)]
    if any(i.op == "LDS" and i.full != "LDS.128" for i in hot):
        raise ValueError(f"{kernel}: expected one LDS.128 per entry")
    ops = Counter(i.op for i in hot)
    per_pair = {
        "alu": sum(n for op, n in ops.items() if op in ALU) / pairs,
        "fma": sum(n for op, n in ops.items() if op in FMA) / pairs,
        "issue": sum(ops.values()) / pairs}
    return {"loop": [hex(head), hex(end)], "pairs_per_iteration": pairs,
            "per_pair": per_pair, "opcodes": dict(sorted(ops.items()))}


def pair_seconds(per_pair: Dict[str, float], sms: int,
                 clock_hz: float) -> Dict:
    """Least time per (packet, entry) pair on ``sms`` SMs at
    ``clock_hz``: the slowest pipe's instructions over its lanes.
    Returns {"seconds", "pipe"}."""
    pipe = max(LANES, key=lambda p: per_pair[p] / LANES[p])
    return {"seconds": per_pair[pipe] / (LANES[pipe] * sms * clock_hz),
            "pipe": pipe}
