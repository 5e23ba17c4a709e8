"""Registers, shared memory, spills and the SASS instruction mix of each
kernel of every ``csrc/*.cu`` source of the port, or of the sources given.

    python -m abcsmc_tpu_torch.kernel_sass [--source OLD.cu ...]
        [--match ffma] [--sass-dir D] [--out F]

Builds each source with the port's nvcc flags plus ``-Xptxas -v`` into
``build/sass/``, reads ptxas's lines for each kernel (registers, bytes of
static shared memory, stack, spill stores and loads), disassembles the
build with ``cuobjdump -sass`` and counts each kernel's instructions by
class (FFMA, FADD, FMNMX, MUFU, LDS, LDG, HMMA; STL and LDL, the local
memory a spill or a thread's own array goes to; CALL; the FP64 pipe's
DFMA, DMUL, DADD; other), over the whole
kernel and over its hot loop: the loop (a backward branch and its
target) that holds the most MUFUs, the shortest of those. In a static
instance each logit takes one MUFU.EX2 in that loop, so the loop's counts
over its MUFUs are the instance's instructions per logit at its full
unrolled width (a loop that breaks out early at a smaller p runs fewer).
One JSON line per kernel; ``--match`` keeps the kernels whose demangled
name holds the text; ``--sass-dir`` keeps each build's disassembly. Needs
nvcc and cuobjdump (the card's machine has both); exits 2 without them.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

from abcsmc_tpu_torch.ops import _build

CLASSES = ("FFMA", "FADD", "FMNMX", "MUFU", "LDS", "LDG", "HMMA", "STL",
           "LDL", "CALL", "DFMA", "DMUL", "DADD")
_INSN = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)"
    r"([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def parse_ptxas(text: str) -> dict:
    """{mangled kernel: {registers, smem_bytes, stack_bytes, spill_stores,
    spill_loads}} from ``-Xptxas -v`` output."""
    out, cur, props = {}, None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            out.setdefault(cur, {})
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props is not None:
            out.setdefault(props, {}).update(
                stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
            props = None
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            out[cur].update(registers=int(m.group(1)),
                            smem_bytes=int(smem.group(1)) if smem else 0)
    return out


def parse_sass(text: str) -> dict:
    """{mangled kernel: [(address, opcode, operands), ...]} from
    ``cuobjdump -sass`` output."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return out


def op_class(opcode: str) -> str:
    return opcode if opcode in CLASSES else "other"


def counts(insns) -> dict:
    c = Counter(op_class(op) for _, op, _ in insns)
    return {k: c.get(k, 0) for k in (*CLASSES, "other")}


def hot_loop(insns):
    """The instructions of the loop (a backward BRA and the span from its
    target to it) that holds the most MUFUs, the shortest of those that
    tie, or None: the loop over a thread's logits, not the split merge's
    loop of one ex2 a split."""
    best, key = None, None
    for addr, op, rest in insns:
        if op != "BRA":
            continue
        t = _TARGET.search(rest)
        if t is None or int(t.group(1), 16) > addr:
            continue
        lo = int(t.group(1), 16)
        body = [x for x in insns if lo <= x[0] <= addr]
        mufu = sum(op == "MUFU" for _, op, _ in body)
        if mufu and (key is None or (-mufu, len(body)) < key):
            best, key = body, (-mufu, len(body))
    return best


def demangle(names) -> dict:
    for tool in (shutil.which("cu++filt"),
                 str(Path(_build.find_nvcc()).parent / "cu++filt"),
                 shutil.which("c++filt")):
        if tool and Path(tool).is_file():
            res = subprocess.run([tool], input="\n".join(names),
                                 capture_output=True, text=True)
            if res.returncode == 0:
                return dict(zip(names, res.stdout.splitlines()))
    return {n: n for n in names}


def analyze(src: Path, match: str | None = None,
            sass_dir: Path | None = None) -> list:
    """One record per kernel of ``src`` (see the module docstring)."""
    nvcc = _build.find_nvcc()
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    out_dir = _build.BUILD_DIR.parent / "sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(_build.source_bytes(src)).hexdigest()[:16]
    so = out_dir / f"{src.stem}-{digest}.so"
    build = subprocess.run(
        [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so),
         str(src)], capture_output=True, text=True)
    if build.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{build.stderr}")
    ptxas = parse_ptxas(build.stderr + build.stdout)
    text = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    if sass_dir is not None:
        sass_dir.mkdir(parents=True, exist_ok=True)
        (sass_dir / f"{so.stem}.sass").write_text(text)
    sass = parse_sass(text)
    names = demangle(sorted(set(ptxas) | set(sass)))
    rows = []
    for mangled, name in names.items():
        if match and match not in name:
            continue
        insns = sass.get(mangled, [])
        loop = hot_loop(insns)
        row = {"source": str(src), "kernel": name, **ptxas.get(mangled, {}),
               "sass_instructions": len(insns), "sass_counts": counts(insns)}
        if loop is not None:
            lc = counts(loop)
            row["hot_loop"] = {
                "instructions": len(loop), "counts": lc,
                "per_mufu": {k: v / lc["MUFU"] for k, v in lc.items()}}
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", type=Path,
                    help="a .cu source (repeatable; default: every "
                         "csrc/*.cu of the port)")
    ap.add_argument("--match", help="keep kernels whose name holds this")
    ap.add_argument("--out", help="also write the JSON lines to this file")
    ap.add_argument("--sass-dir", type=Path,
                    help="also write each source's cuobjdump -sass there")
    args = ap.parse_args(argv)
    try:
        _build.find_nvcc()
    except RuntimeError as e:
        print(f"kernel_sass: {e}", file=sys.stderr)
        return 2
    rows = []
    for src in args.source or sorted(_build.CSRC.glob("*.cu")):
        for row in analyze(src, args.match, args.sass_dir):
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
