"""The machine code of each kernel of a CUDA source (``csrc/<source>``) in
this checkout against the same source built from another copy of
``csrc/`` (an earlier commit's), on a machine with the CUDA toolkit:

    python -m tds_tpu_torch.tools.sass_ab --other PATH/TO/tds_tpu_torch/csrc [--source pgs.cu megastep.cu]

Both libraries are built with nvcc (``utils.cuda_build``, into
``build/kernels/``); ``cuobjdump -sass`` lists each kernel's instructions
and ``cu++filt`` names it. Kernels are matched by their name without the
parameter list and without the template flags at the end of their
arguments that are false: a parameter added at the end of a kernel's list,
or a flag added last with a default of false, changes its mangled name,
and the instructions of an instance that never reads it not at all. For
each kernel it prints one JSON line: whether its instructions are
the same in both libraries (their text; addresses and encodings left out),
how many each has and how many differ, and each library's registers,
stack bytes and local memory (``cuobjdump -res-usage``); then one line per
source with the counts. Needs no card.
"""

import argparse
import difflib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

from tds_tpu_torch.utils import cuda_build

_FUNCTION = re.compile(r"Function\s*:\s*(\S+)")
_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
_RESOURCES = re.compile(r"Function (\S+):\s*\n\s*REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)")


def _tool(name):
    return os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", name)


def _run(*cmd, stdin=None):
    return subprocess.run(cmd, input=stdin, capture_output=True, text=True, check=True, timeout=600).stdout


def kernel_key(demangled):
    """A kernel's demangled name without its parameter list (the last
    balanced parenthesised group), its return type and the false flags at
    the end of its template arguments."""
    name, depth, end = demangled, 0, len(demangled.rstrip())
    for i in range(end - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(demangled[i], 0)
        if depth == 0 and demangled[i] == "(":
            name = demangled[:i].removeprefix("void ").strip()
            break
    while name.endswith((", (bool)0>", ", false>")):
        name = name[:name.rindex(",")] + ">"
    return name


def kernels(lib):
    """{key: (instructions, (registers, stack, local))} of every kernel in
    the shared library ``lib``."""
    code, blocks, current = _run(_tool("cuobjdump"), "-sass", str(lib)), {}, None
    for line in code.splitlines():
        found = _FUNCTION.search(line)
        if found:
            current = blocks.setdefault(found.group(1), [])
            continue
        found = _INSTRUCTION.search(line)
        if found and current is not None:
            current.append(" ".join(found.group(1).split()))
    usage = {m.group(1): (int(m.group(2)), int(m.group(3)), int(m.group(5)))
             for m in _RESOURCES.finditer(_run(_tool("cuobjdump"), "-res-usage", str(lib)))}
    names = list(blocks)
    demangled = _run(_tool("cu++filt"), stdin="\n".join(names) + "\n").splitlines()
    return {kernel_key(d): (blocks[m], usage.get(m)) for m, d in zip(names, demangled)}


def compare(source, other):
    """One line a kernel of ``source``, then the source's counts."""
    this = kernels(cuda_build.build(source))
    that = kernels(cuda_build.build(source, Path(other)))
    same = 0
    for key in sorted(set(this) | set(that)):
        line = {"source": source, "kernel": key}
        if key not in this or key not in that:
            line["only_in"] = "this" if key in this else "other"
        else:
            (mine, mine_usage), (theirs, their_usage) = this[key], that[key]
            changed = sum(1 for op in difflib.ndiff(theirs, mine) if op[:1] in "+-")
            line.update(same=mine == theirs, this_instructions=len(mine), other_instructions=len(theirs),
                        instructions_differing=changed, this_registers_stack_local=mine_usage,
                        other_registers_stack_local=their_usage)
            same += mine == theirs
        print(json.dumps(line), flush=True)
    print(json.dumps({"source": source, "kernels_this": len(this), "kernels_other": len(that),
                      "same_instructions": same}), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, help="another copy of tds_tpu_torch/csrc")
    parser.add_argument("--source", nargs="+", default=["pgs.cu", "megastep.cu"])
    args = parser.parse_args(argv)
    for source in args.source:
        compare(source, args.other)
    return 0


if __name__ == "__main__":
    sys.exit(main())
