"""Compiled code of the kernels against another tree's.

    python -m snail_tpu_torch.sass_check OTHER_TREE [--out FILE]

Compiles every kernel source of ``snail_tpu_torch/csrc`` (``ops/_build.py``
SOURCES: worklist.cu, walk.cu, fat.cu, volume.cu, shade.cu) of this tree
and of ``OTHER_TREE`` (a checkout of another commit) with the build's flags
(``ops/_build.py``: sm_90a, ``--fmad=false``, ``-Xptxas -v``), all at
once, and prints for each kernel of either the registers, stack and spills
that ptxas reports, its SASS instruction count (``cuobjdump -sass``) and
whether its SASS is the other tree's instruction for instruction. With
``--out`` the SASS of both trees goes to FILE. Needs ``nvcc`` and
``cuobjdump`` (the CUDA toolkit), no card.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from .ops._build import CSRC, NVCC_FLAGS, SOURCES, _nvcc


def _demangle(names):
    """Kernel names with their template arguments, without the parameter
    list, the return type or the anonymous namespace, whose mangled name
    carries a hash of its file."""
    tool = shutil.which("cu++filt") or str(Path(_nvcc()).parent / "cu++filt")
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True, check=True).stdout
    short = []
    for n in out.splitlines():
        n = re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::", "", n)
        depth = 0
        for i, ch in enumerate(n):  # the parameter list: "(" outside <>
            depth += (ch == "<") - (ch == ">")
            if ch == "(" and depth == 0:
                n = n[:i]
                break
        short.append(n)
    return short


def compile_source(src: Path, tmp: Path):
    """(ptxas report, SASS) of one source: {kernel: {regs, stack, spill
    stores, spill loads}}, {kernel: [instruction lines]}; ({}, {}) where
    the tree has no such source. ``tmp``: a directory of its own."""
    if not src.exists():
        return {}, {}
    tmp.mkdir(parents=True)
    obj = tmp / "k.o"
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(src.parent), "-c",
                          "-o", str(obj), str(src)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
    report, name = {}, None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            report[name] = {}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            report[name].update(stack=int(m[1]), spill_stores=int(m[2]),
                                spill_loads=int(m[3]))
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report.setdefault(name, {})["regs"] = int(m[1])
    tool = shutil.which("cuobjdump") or str(Path(_nvcc()).parent
                                            / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(obj)], capture_output=True,
                          text=True, check=True).stdout
    code, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            code[name] = []
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            code[name].append(line.split(";")[0].split("*/", 1)[1].strip())
    names = sorted(set(report) | set(code))
    short = dict(zip(names, _demangle(names)))
    return ({short[n]: r for n, r in report.items()},
            {short[n]: c for n, c in code.items()})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    trees = {"this": CSRC, "other": args.other / "snail_tpu_torch" / "csrc"}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor() as ex:
        jobs = {(tree, name): ex.submit(compile_source, csrc / name,
                                        Path(tmp) / tree / name)
                for tree, csrc in trees.items() for name in SOURCES}
        done = {key: job.result() for key, job in jobs.items()}
    rows = []
    for name in SOURCES:
        (rep_a, ours), (rep_b, theirs) = (done["this", name],
                                          done["other", name])
        for k in sorted(set(ours) | set(theirs)):
            a, b = ours.get(k), theirs.get(k)
            rows.append({"source": name, "kernel": k, "this": rep_a.get(k),
                         "other": rep_b.get(k),
                         "instructions": [len(a or []), len(b or [])],
                         "identical": a is not None and a == b})
            print(f"{name} {k}: this {rep_a.get(k)} {len(a or [])} "
                  f"instructions; other {rep_b.get(k)} {len(b or [])} "
                  f"instructions; SASS "
                  f"{'identical' if rows[-1]['identical'] else 'differs'}",
                  flush=True)
    if args.out:
        args.out.write_text("\n".join(
            f"== {tree} {name} {k}\n" + "\n".join(c)
            for tree in trees for name in SOURCES
            for k, c in sorted(done[tree, name][1].items())))
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
