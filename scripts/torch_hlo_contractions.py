"""Where XLA contracts a multiply into a fused multiply-add in the JAX
package's compiled five-point solver: the fusions of one compiled call on
the CPU, the source lines of their arithmetic, the fusions each one reads,
and the fused multiply-add instructions in each fusion's object code. The
port's ``pmv_tpu_torch/solvers/five_point.py`` mirrors what this shows.

    JAX_PLATFORMS=cpu python3 scripts/torch_hlo_contractions.py
        [--call candidates|ransac] [--function _poly_from_rows]
        [--show FUSION] [--keep DIR]

``--call candidates`` (the default) compiles ``pmv_tpu``'s
``five_point_candidates`` vmapped over 64 hypotheses, as its five-point
RANSAC calls it; ``--call ransac`` compiles ``find_essential_5pt_ransac`` at
512 feature slots. Both under ``jax.jit`` on the CPU, with
``XLA_FLAGS=--xla_dump_to=DIR --xla_dump_hlo_as_text`` (a temporary DIR
unless ``--keep``). The script reads the optimized HLO
(``*.cpu_after_optimizations.txt``) and disassembles each fusion's object
file (``objdump -d``), and prints one line per fusion with arithmetic from
``--function`` (a function of ``pmv_tpu/solvers/five_point.py``, the
functions nested in it included; default ``_poly_from_rows``): its name, the
fusions it reads, its source lines, its multiplies, adds and subtracts, and
its fused multiply-adds (``vfmadd``/``vfmsub``/``vfnmadd``/``vfnmsub``;
``ss`` scalar, ``ps`` packed) beside its plain ``vmul``/``vadd``/``vsub``.
``--show FUSION`` prints that fusion's HLO with the source line of each
instruction. Needs ``objdump`` (binutils).

Reading it: a multiply and the add it feeds, in one fusion, become one
fused multiply-add (one rounding) where LLVM picks that pair; a sum that
crosses fusions is rounded on each side. The LLVM IR of a fusion
(``*_kernel_module.ir-with-opt.ll`` in DIR) shows the operand order LLVM
chose; the port's ``_fusion`` in five_point.py replays its rules.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FMA = re.compile(r"\bvf(?:n?m(?:add|sub)|madd|msub)\d*([sp][sd])\b")
PLAIN = re.compile(r"\bv(mul|add|sub)([sp][sd])\b")


def compile_call(call: str, dump: str) -> None:
    """Compile the call under ``jax.jit`` on the CPU with the HLO and the
    object code dumped to ``dump``."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_dump_to={dump} --xla_dump_hlo_as_text").strip()
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from pmv_tpu.solvers import five_point

    if call == "candidates":
        x = jnp.zeros((64, 5, 2), jnp.float32)
        jax.jit(jax.vmap(five_point.five_point_candidates)).lower(x, x).compile()
    else:
        p = jnp.zeros((512, 2), jnp.float32)
        five_point.find_essential_5pt_ransac.lower(
            p, p, jnp.ones(512, bool), jnp.eye(3, dtype=jnp.float32), jax.random.PRNGKey(0),
            n_hypos=64).compile()


def parse_hlo(path: Path):
    """(computations {name: [instruction lines]}, the entry's name, a
    function mapping an instruction line to its call stack [(function,
    line), ...] innermost first)."""
    files, funcs, locs, frames = {}, {}, {}, {}
    comps: dict[str, list[str]] = collections.OrderedDict()
    section, cur, entry = None, None, None
    for line in path.read_text().split("\n"):
        if line in ("FileNames", "FunctionNames", "FileLocations", "StackFrames"):
            section = line
            continue
        if section:
            if not line.strip():
                section = None
                continue
            key, rest = line.split(" ", 1)
            if section == "FileNames":
                files[int(key)] = rest.strip('"')
            elif section == "FunctionNames":
                funcs[int(key)] = rest.strip('"')
            else:
                fields = dict(re.findall(r"(\w+)=(\w+)", rest))
                (locs if section == "FileLocations" else frames)[int(key)] = fields
            continue
        m = re.match(r"^(ENTRY )?%(\S+) \(", line)
        if m:
            cur = m.group(2)
            comps[cur] = []
            entry = cur if m.group(1) else entry
        elif line.startswith("}"):
            cur = None
        elif cur and line.strip():
            comps[cur].append(line.strip())

    def stack(instr: str):
        m = re.search(r"stack_frame_id=(\d+)", instr)
        out, fid = [], int(m.group(1)) if m else None
        while fid in frames:
            loc = locs[int(frames[fid]["file_location_id"])]
            if files[int(loc["file_name_id"])].endswith("pmv_tpu/solvers/five_point.py"):
                out.append((funcs[int(loc["function_name_id"])], int(loc["line"])))
            parent = int(frames[fid]["parent_frame_id"])
            fid = None if parent == fid else parent
        return out

    return comps, entry, stack


def opcode(instr: str) -> str:
    m = re.match(r"(?:ROOT )?%\S+ = \S+ ([\w-]+)\(", instr)
    return m.group(1) if m else ""


def machine_code(dump: Path, prefix: str, fusion: str) -> collections.Counter:
    """Counts of fused multiply-adds and plain multiplies/adds/subtracts in
    the fusion's object code."""
    obj = dump / f"{prefix}.obj-file.{fusion}_kernel_module.o"
    if not obj.exists():
        return collections.Counter()
    text = subprocess.run(["objdump", "-d", "--no-show-raw-insn", str(obj)],
                          capture_output=True, text=True, check=True).stdout
    n = collections.Counter()
    for line in text.split("\n"):
        if FMA.search(line):
            n["fma_" + FMA.search(line).group(1)] += 1
        elif PLAIN.search(line):
            m = PLAIN.search(line)
            n[f"{m.group(1)}_{m.group(2)}"] += 1
    return n


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--call", choices=["candidates", "ransac"], default="candidates")
    ap.add_argument("--function", default="_poly_from_rows")
    ap.add_argument("--show", default=None, metavar="FUSION")
    ap.add_argument("--keep", default=None, metavar="DIR")
    args = ap.parse_args()
    dump = Path(args.keep or tempfile.mkdtemp(prefix="pmv_hlo_"))
    dump.mkdir(parents=True, exist_ok=True)
    compile_call(args.call, str(dump))
    name = "five_point_candidates" if args.call == "candidates" else "find_essential_5pt_ransac"
    hlo = sorted(dump.glob(f"module_*.jit_{name}.cpu_after_optimizations.txt"))[-1]
    prefix = hlo.name[: -len(".cpu_after_optimizations.txt")]
    comps, entry, stack = parse_hlo(hlo)

    fusions = []  # (caller computation, fusion instruction)
    for comp, instrs in comps.items():
        for ins in instrs:
            if opcode(ins) == "fusion" and "calls=%" in ins:
                fusions.append((comp, ins))
    if args.show:
        for _, ins in fusions:
            if ins.split(" = ")[0].lstrip("ROOT ").lstrip("%") == args.show:
                body = re.search(r"calls=%([\w.\-]+)", ins).group(1)
                print(re.sub(r", metadata=\{.*?\}(?=,|$)", "", ins))
                for line in comps[body]:
                    where = stack(line)
                    print("   ", re.sub(r", metadata=\{.*?\}(?=,|$)", "", line)[:200],
                          f"# five_point.py:{where[0][1]} {where[0][0]}" if where else "")
        return 0
    print(f"# {hlo}")
    print("# fusion | reads | five_point.py lines (functions) | multiply/add/subtract | "
          "machine code: fused multiply-adds, plain ops")
    for _, ins in fusions:
        fname = re.match(r"(?:ROOT )?%(\S+) =", ins).group(1)
        body = re.search(r"calls=%([\w.\-]+)", ins).group(1)
        arith = [line for line in comps[body] if opcode(line) in ("multiply", "add", "subtract")]
        where = [s for line in arith for s in stack(line)]
        if not any(f == args.function or f.startswith(args.function + ".") for f, _ in where):
            continue
        reads = [r for r in re.findall(r"%([\w.\-]+)", ins.split("fusion(", 1)[1].split(")")[0])
                 if "fusion" in r]
        lines = sorted({ln for f, ln in where if f.startswith(args.function)})
        names = sorted({f.split(".<locals>.")[-1] for f, _ in where if f.startswith(args.function)})
        ops = collections.Counter(opcode(line) for line in arith)
        mc = machine_code(dump, prefix, fname)
        code = " ".join(f"{k} {v}" for k, v in sorted(mc.items())) if mc else "no kernel of its own"
        print(f"{fname} | {', '.join(reads) or '-'} | {','.join(map(str, lines))} ({', '.join(names)}) | "
              f"{ops['multiply']}/{ops['add']}/{ops['subtract']} | {code}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
