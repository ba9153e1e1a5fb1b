"""The floor of a loop's carried chain, counted from its SASS (used by
tools/omlsa_profile.py --floor).

A loop over frames that carries a value from one frame to the next
(OM-LSA's gain, csrc/omlsa.cu) can run no faster than its longest chain of
dependent instructions from one frame's carries to the next's.
floor_of() reads the loop's instructions from `cuobjdump -sass` text,
follows the common path through it (a forward branch is taken where the
code it skips holds a call, an FCHK or an inner loop: the division's slow
path, the frame run again, a V-frame boundary's ring), and runs that
path's register dependencies alone, every instruction issued the moment
its operands are ready, for many iterations.  The growth a frame over the
last half is the floor; the chain printed is the last frame's, from its
latest carried register back to the frame before.  Memory, issue slots
and branches are left out: the floor is a lower bound, what one frame's
dependent latencies allow.

probe_latencies() (one CUDA card and nvcc) builds tools/sass_latency.cu,
runs its loops of dependent steps and counts each loop's steps in the
library's own SASS: -> {opcode: cycles}.  Opcodes without a probe take a
class's (integer ALU instructions LOP3's, a predicate's setter FSETP's,
the rest FFMA's); DEPBAR, stores and branches take 0.
"""

import ctypes
import re
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# tools/sass_latency.cu's probes in order: the SASS opcode a chain's steps
# are counted by, and the opcode each step runs beside it (its latency
# taken off the step's)
PROBES = [("FFMA", None), ("FADD", None), ("FMUL", None), ("FMNMX", None),
          ("FSETP", None), ("MUFU.RCP", "FFMA"), ("MUFU.EX2", None),
          ("MUFU.LG2", None), ("IMAD", None), ("LOP3", "IMAD"),
          ("LDS", None)]
# opcodes without a probe that run where a probed one runs
_LIKE = {"IADD3": "LOP3", "LEA": "LOP3", "SHF": "LOP3", "SEL": "LOP3",
         "PRMT": "LOP3", "VIADD": "IMAD"}

_NO_RESULT = {"ST", "STG", "STS", "STL", "LDGSTS", "BRA", "EXIT", "BSSY",
              "BSYNC", "NOP", "DEPBAR", "LDGDEPBAR", "CALL", "RET",
              "WARPSYNC", "BAR", "RED", "MEMBAR", "YIELD", "CCTL"}
_PREDICATE_SETTERS = {"FSETP", "ISETP", "DSETP", "PLOP3", "UISETP",
                      "UPLOP3", "FSET", "PSETP"}
_SLOW = re.compile(r"^(CALL|FCHK)")
_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;\s*(?:/\*|$)")
_REG = re.compile(r"(?<![\w.])!?-?\|?((?:U?R|U?P)\d+)(\.64)?")


class Instr:
    """One SASS instruction: address, guard, opcode, registers read and
    written."""

    def __init__(self, addr, text):
        self.addr, self.text = addr, text
        guard = re.match(r"@(!?)(U?P\w+)\s+", text)
        self.guard = guard.group(2) if guard and guard.group(2) not in (
            "PT", "UPT") else None
        body = text[guard.end():] if guard else text
        op, _, rest = body.partition(" ")
        self.op = op
        self.base = op.split(".")[0]
        self.operands = [o.strip() for o in rest.split(",")] if rest else []
        self.target = None
        if self.base == "BRA":
            m = re.search(r"0x([0-9a-f]+)\s*$", rest.strip())
            self.target = int(m.group(1), 16) if m else None
        self.dests, self.srcs = self._registers()

    @staticmethod
    def _regs(operand):
        out = []
        for name, wide in _REG.findall(operand):
            out.append(name)
            if wide:
                kind, num = re.match(r"(\D+)(\d+)", name).groups()
                out.append(f"{kind}{int(num) + 1}")
        return out

    def _registers(self):
        ops = self.operands
        if self.base in _NO_RESULT or not ops:
            dests, rest = [], ops
        elif self.base in _PREDICATE_SETTERS or (
                self.base in ("LOP3", "ULOP3") and
                re.match(r"U?P[\dT]", ops[0])):
            dests, rest = ops[:2], ops[2:]
        else:
            n = 1
            # carry-out predicates right after the result (IADD3 R, P0, ...)
            while n < len(ops) and re.fullmatch(r"U?P[\dT]", ops[n]):
                n += 1
            dests, rest = ops[:n], ops[n:]
        width = 4 if ".128" in self.op else 2 if (
            ".64" in self.op or ".WIDE" in self.op) else 1
        out = []
        for d in dests:
            for name in self._regs(d):
                kind, num = re.match(r"(\D+)(\d+)", name).groups()
                out += [f"{kind}{int(num) + k}" for k in range(
                    width if kind in ("R", "UR") else 1)]
        srcs = [r for o in rest for r in self._regs(o)]
        if self.guard:
            srcs += [self.guard] + out  # a false guard keeps the old value
        return out, srcs


def parse(text):
    """cuobjdump -sass text -> {function name: [Instr]}."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _LINE.search(line)
        if cur is not None and m:
            cur.append(Instr(int(m.group(1), 16), m.group(2)))
    return funcs


def find(funcs, kernel):
    """The one function whose mangled name holds ``kernel`` (as a whole
    name: its length, then the name, and what follows)."""
    name = kernel.split("I")[0] if "ILi" in kernel else kernel
    names = [n for n in funcs if f"{len(name)}{kernel}" in n]
    if len(names) != 1:
        raise KeyError(f"{kernel}: {len(names)} functions match")
    return funcs[names[0]]


def loop_path(code):
    """The widest loop's common path: (head address, end address,
    [Instr] in the order one iteration runs them)."""
    back = [(i.addr - i.target, k) for k, i in enumerate(code)
            if i.base == "BRA" and i.target is not None and i.target < i.addr]
    if not back:
        raise ValueError("no loop")
    _, end_k = max(back)
    head = code[end_k].target
    at = {i.addr: k for k, i in enumerate(code)}
    k, path = at[head], []
    while k != end_k:
        ins = code[k]
        if _SLOW.match(ins.op):
            raise ValueError(f"the common path reaches {ins.text}")
        if ins.base == "BRA" and ins.target is not None:
            skipped = [c for c in code if k < at.get(c.addr, -1) and
                       c.addr < ins.target]
            rare = any(_SLOW.match(c.op) or (
                c.base == "BRA" and c.target is not None and
                c.target < c.addr) for c in skipped)
            conditional = ins.guard is not None or len(ins.operands) > 1
            if ins.target > ins.addr and (rare or not conditional):
                k = at[ins.target]
                continue
        path.append(ins)
        k += 1
    return head, code[end_k].addr, path


def latency(ins, table):
    """Cycles from ``ins`` issuing to its result being readable."""
    if ins.base in _NO_RESULT:
        return 0
    for key in (ins.op, ".".join(ins.op.split(".")[:2]), ins.base,
                _LIKE.get(ins.base)):
        if key in table:
            return table[key]
    if ins.base in _PREDICATE_SETTERS:
        return table["FSETP"]
    return table["FFMA"]


def _real(r):
    return not r.endswith("Z") and r not in ("PT", "UPT")


def recurrence(path, table, iters=64):
    """Run ``path``'s dependencies for ``iters`` iterations with unlimited
    issue: -> (cycles an iteration over the last half, the chain of the
    last iteration that ends latest in a carried register, back to the
    iteration before, as [(address, opcode, cycles)]).  A carried register
    is one the path reads before it writes it."""
    carried, written = set(), set()
    for ins in path:
        carried |= {r for r in ins.srcs if _real(r)} - written
        written |= set(ins.dests)
    ready = {}  # register -> (time, (iteration, index) of its writer)
    ends, runs = [], []
    for it in range(iters):
        writers = []  # (done, the writer of its latest operand)
        for k, ins in enumerate(path):
            start, pred = 0, None
            for r in ins.srcs:
                if r in ready and ready[r][0] > start:
                    start, pred = ready[r]
            done = start + latency(ins, table)
            writers.append((done, pred))
            for r in ins.dests:
                if _real(r):
                    ready[r] = (done, (it, k))
        runs.append(writers)
        ends.append(max([ready[r][0] for r in carried if r in ready] + [0]))
    half = iters // 2
    floor = (ends[-1] - ends[half - 1]) / (iters - half)
    last = max((ready[r] for r in carried if r in ready),
               key=lambda v: v[0])
    chain, cur = [], last[1]
    while cur is not None and cur[0] == iters - 1:
        ins = path[cur[1]]
        chain.append((f"{ins.addr:04x}", ins.op, latency(ins, table)))
        cur = runs[-1][cur[1]][1]
    if cur is not None:
        ins = path[cur[1]]
        chain.append((f"{ins.addr:04x}", ins.op + " (frame before)",
                      latency(ins, table)))
    return floor, chain[::-1]


def chain_opcodes(chain):
    """{opcode: count} over a chain (the frame before's entry left out)."""
    counts = {}
    for _, op, _ in chain:
        if not op.endswith("(frame before)"):
            counts[op] = counts.get(op, 0) + 1
    return counts


def floor_of(sass_text, kernel, table):
    """-> {loop, path length, floor cycles a frame, the chain}."""
    head, end, path = loop_path(find(parse(sass_text), kernel))
    floor, chain = recurrence(path, table)
    return {"kernel": kernel, "loop": [f"{head:04x}", f"{end:04x}"],
            "path_instructions": len(path), "floor_cycles_a_frame": floor,
            "chain_opcodes": chain_opcodes(chain), "chain": chain}


def resolve(step):
    """{opcode: cycles a probe's step} -> {opcode: cycles}: a step's
    cycles less those of the instruction run beside it; the FSETP probe's
    step (FSETP, then FSEL) split as FSEL an ALU select (FMNMX's latency)
    and the rest FSETP's."""
    table = {}
    while len(table) < len(PROBES):
        for op, before in PROBES:
            if op in table or (before and before not in table):
                continue
            table[op] = None if step[op] is None or (
                before and table[before] is None) else \
                step[op] - (table[before] if before else 0)
    pair = table["FSETP"]
    table["FSEL"] = table["FMNMX"]
    table["FSETP"] = None if None in (pair, table["FSEL"]) else \
        pair - table["FSEL"]
    return table


def probe_latencies(nvcc, build_dir, m=64):
    """Build and run tools/sass_latency.cu on the card (its SASS kept in
    ``build_dir``), each probe over m and 2m iterations: -> ({opcode:
    cycles}, each probe's cycles and counted steps a body)."""
    build_dir.mkdir(parents=True, exist_ok=True)
    lib_path = build_dir / "libsass_latency.so"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(lib_path), str(ROOT / "tools/sass_latency.cu")],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.sass_latency.argtypes = [ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
    if lib.sass_latency_probes() != len(PROBES):
        raise RuntimeError("tools/sass_latency.cu's probes and PROBES differ")
    sass = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass",
                           str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    (build_dir / "sass_latency.sass").write_text(sass)
    funcs = parse(sass)
    step, raw = {}, {}
    for p, (op, _) in enumerate(PROBES):
        out = (ctypes.c_longlong * 3)()
        if lib.sass_latency(p, m, ctypes.addressof(out)) != 0:
            raise RuntimeError(f"probe {p} failed")
        code = find(funcs, f"probe_kernelILi{p}E")
        clocks = [k for k, i in enumerate(code) if "SR_CLOCKLO" in i.text]
        body = sum(1 for i in code[clocks[0]:clocks[1]]
                   if i.op == op or i.op.startswith(op + "."))
        raw[op] = {"cycles": list(out), "steps_a_body": body}
        step[op] = (out[2] - out[1]) / (m * body) if body else None
    return resolve(step), raw
