"""What the inner loop of a built GEMM or conv kernel issues per product,
read from its SASS, and the least time an SM needs for that.

``chip_smoke.py`` bounds the log-domain kernels by the instructions they
issue, not by the reference's expression: for every instantiation of
``csrc/cim_gemm.cuh``'s ``gemm_kernel`` in a built library it finds the
product loop (the innermost loop after the block's second barrier), counts
its instructions by the pipe that runs them and divides by the products
one pass of the loop makes.  ``csrc/cluster_gemm.cuh``'s
``cluster_gemm_kernel`` unrolls its products: there the section that
counts is the K-step loop's tail, from its second barrier to its
backward branch (``step_products``); ``csrc/attn_cluster.cuh``'s
attention kernel runs its products in row loops, found by the dp4a they
issue (``idp_loops``).  Rates per SM and clock on Hopper (CUDA C++
Programming Guide, compute capability 9.0): 64 integer ALU lanes (IADD3,
LOP3, SHF, ISETP, SEL, ...), 64 lanes of the FMA pipe that runs IMAD and
the byte dot product IDP (dp4a), 16
for FLO and the other quarter-rate operations, and four schedulers that
issue one warp instruction (32 lanes) a clock each, 128 in all.  An
instruction that runs on either integer pipe (VIADD, VIMNMX, MOV) counts
only toward the issue limit, so the bound stays a lower one; loads,
branches and uniform-datapath instructions are not counted at all.

It also counts the tensor-core instructions (``IMMA``, from
``mma.sync``; ``IGMMA``, from ``wgmma``) of each function, so that
``chip_smoke.py`` can show that the int8 kernels of ``csrc/int8_mma.cuh``
run on the tensor cores.

Only text is parsed here; `disassemble` needs the CUDA toolkit's
``cuobjdump`` and runs on the machine with the card.
"""

from __future__ import annotations

import os
import re
import subprocess
from typing import Dict, List, NamedTuple, Tuple

# lanes a clock on one SM, by pipe; "int" is every arithmetic
# instruction together, against the four schedulers' issue
RATES = {"alu": 64, "fma": 64, "xu": 16, "int": 128}
_FMA = {"IMAD", "IDP", "FFMA", "FADD", "FMUL", "HFMA2", "HADD2", "HMUL2"}
_ALU = {"IADD3", "LOP3", "SHF", "ISETP", "FSETP", "SEL", "FSEL", "LEA",
        "IABS", "PRMT", "PLOP3", "IMNMX", "FMNMX", "BMSK", "SGXT", "P2R",
        "R2P"}
_XU = {"FLO", "POPC", "BREV", "MUFU", "I2F", "F2I", "F2F", "I2I", "FRND"}
_EITHER = {"VIADD", "VIMNMX", "VIADDMNMX", "MOV"}

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"\s*([^;]*);")


class Insn(NamedTuple):
    pc: int
    pred: str       # "" or the guard, e.g. "@!P0"
    op: str         # the full opcode, e.g. "ISETP.NE.AND"
    args: str


def disassemble(lib: str) -> str:
    """The SASS of a built library, from the toolkit's cuobjdump."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout


def functions(sass: str) -> Dict[str, List[Insn]]:
    """{mangled name: its instructions in address order}."""
    out: Dict[str, List[Insn]] = {}
    cur = None
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSN.match(line)
        if m and cur is not None:
            cur.append(Insn(int(m.group(1), 16), (m.group(2) or "").strip(),
                            m.group(3), m.group(4).strip()))
    return out


# the tensor-core matrix instructions of integer operands
TENSOR_CORE_OPS = ("IMMA", "IGMMA")


def tensor_core_counts(insns: List[Insn]) -> Dict[str, int]:
    """{opcode: instructions} of one function, for IMMA and IGMMA."""
    out = {op: 0 for op in TENSOR_CORE_OPS}
    for x in insns:
        base = x.op.split(".")[0]
        if base in out:
            out[base] += 1
    return out


def pipe(op: str) -> str:
    """The pipe an opcode issues to: alu, fma, xu, either (an integer op
    nvcc may place on the ALU or the FMA pipe), or other (memory,
    control, uniform datapath: issue only)."""
    base = op.split(".")[0]
    for name, ops in (("fma", _FMA), ("alu", _ALU), ("xu", _XU),
                      ("either", _EITHER)):
        if base in ops:
            return name
    return "other"


def _target(insn: Insn, variants: bool = False):
    """The branch target of a BRA (with `variants`, of any BRA.*), else
    None."""
    m = re.search(r"0x([0-9a-f]+)\s*$", insn.args)
    op = insn.op.split(".")[0] if variants else insn.op
    return int(m.group(1), 16) if op == "BRA" and m else None


def product_loop(insns: List[Insn], bk: int) -> Tuple[List[Insn], int]:
    """The product loop of one gemm_kernel instantiation and the K steps
    one pass of it covers.

    The loop is the first backward branch that starts after the last
    BAR.SYNC (the one that publishes the staged operands) and holds no
    loop of its own; its pass covers `step` K columns, read from the
    induction it closes on (``ISETP.NE Pn, PT, Rk, bk`` against
    ``VIADD/IADD3 Rk, Rk, step``).  Raises if the code has no such loop,
    i.e. if the kernel's shape changed under this reader."""
    at = {ins.pc: i for i, ins in enumerate(insns)}
    bars = [i for i, ins in enumerate(insns) if ins.op.startswith("BAR.SYNC")]
    found = None
    for j, ins in enumerate(insns):
        t = _target(ins)
        if t is None or t > ins.pc or t not in at or not bars \
                or at[t] <= bars[-1]:
            continue
        body = insns[at[t]:j + 1]
        if not any((_target(x) or ins.pc + 1) < x.pc for x in body[:-1]):
            found = (body, ins.pred)
            break
    if found is None:
        raise ValueError("no product loop (a backward branch after the "
                         "last BAR.SYNC) in this function")
    body, pred = found
    p = pred.lstrip("@!")
    cmp = [x for x in body if x.op.startswith("ISETP")
           and re.match(rf"{p}, PT, (R\d+), (0x[0-9a-f]+|\d+), PT$", x.args)]
    for c in cmp:
        reg, lim = re.match(rf"{p}, PT, (R\d+), (\S+), PT$", c.args).groups()
        if int(lim, 0) != bk:
            continue
        for x in body:
            m = re.match(rf"{reg}, {reg}, (0x[0-9a-f]+|\d+)(, RZ)?$", x.args)
            if x.op in ("VIADD", "IADD3") and m:
                return body, int(m.group(1), 0)
    raise ValueError(f"the product loop's induction against {bk} was not "
                     "found")


def step_products(insns: List[Insn]) -> List[Insn]:
    """The product section of one ``cluster_gemm_kernel`` instantiation.

    Its K-step loop is the backward branch whose body holds exactly two
    BAR.SYNC (a stage has landed; the staged x is visible); the products
    run from the second barrier to that branch, unrolled.  Raises if no
    loop has that shape or if the section holds a loop of its own."""
    at = {ins.pc: i for i, ins in enumerate(insns)}
    for j, ins in enumerate(insns):
        t = _target(ins, variants=True)
        if t is None or t > ins.pc or t not in at:
            continue
        body = insns[at[t]:j + 1]
        bars = [i for i, x in enumerate(body) if x.op.startswith("BAR.SYNC")]
        if len(bars) != 2:
            continue
        section = body[bars[1] + 1:]
        back = [_target(x, variants=True) for x in section[:-1]]
        if any(b is not None and b <= x.pc
               for b, x in zip(back, section[:-1])):
            raise ValueError("the K-step loop's product section holds a loop")
        return section
    raise ValueError("no K-step loop (a backward branch over two BAR.SYNC) "
                     "in this function")


def idp_loops(insns: List[Insn]) -> List[Tuple[List[Insn], int]]:
    """The innermost loops of a function (a backward branch whose body
    holds no loop of its own) that issue IDP (dp4a), each with the IDP
    instructions of one pass: ``csrc/attn_cluster.cuh``'s tile GEMM row
    loops, whose products a pass follow from them (mitchell two a dp4a,
    log_our one)."""
    at = {ins.pc: i for i, ins in enumerate(insns)}
    out = []
    for j, ins in enumerate(insns):
        t = _target(ins, variants=True)
        if t is None or t > ins.pc or t not in at:
            continue
        body = insns[at[t]:j + 1]
        back = [_target(x, variants=True) for x in body[:-1]]
        if any(b is not None and b <= x.pc for b, x in zip(back, body[:-1])):
            continue
        idp = sum(x.op.split(".")[0] == "IDP" for x in body)
        if idp:
            out.append((body, idp))
    return out


def section_per_product(body: List[Insn],
                        products: int) -> Dict[str, float]:
    """Instructions per product of a section that makes `products`
    products, by pipe, and "int", the arithmetic ones of every pipe
    together (loads, branches and uniform-datapath instructions are left
    out)."""
    counts = {k: 0.0 for k in ("alu", "fma", "xu", "either", "other")}
    for x in body:
        counts[pipe(x.op)] += 1
    out = {k: v / products for k, v in counts.items()}
    out["int"] = out["alu"] + out["fma"] + out["xu"] + out["either"]
    return out


def per_product(insns: List[Insn], bk: int, rows: int) -> Dict[str, float]:
    """`section_per_product` of the template's product loop; `rows` is the
    outputs each thread accumulates per K step (BM / TY of the
    template)."""
    body, step = product_loop(insns, bk)
    return section_per_product(body, step * rows)


def clocks_per_product(counts: Dict[str, float]) -> Tuple[float, str]:
    """The least SM clocks one product takes at the pipes' rates (an SM's
    products spread over all its lanes), and the term that sets it."""
    terms = {k: counts[k] / RATES[k] for k in RATES}
    name = max(terms, key=terms.get)
    return terms[name], name
