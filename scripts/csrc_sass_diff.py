"""Compare the machine code of two trees of the port's CUDA sources.

    python scripts/csrc_sass_diff.py OLD_CSRC_DIR NEW_CSRC_DIR [STEM ...]

Builds each ``STEM.cu`` (default: every ``.cu`` both trees have) of both
trees to a cubin with the flags of ``_build.NVCC_FLAGS``, prints
ptxas' register and spill counts, and for every kernel of the old tree
says whether the new tree has a kernel with the same SASS instructions
(names and addresses stripped), in any of the compared sources (a kernel
whose entry moved to another source is found there, and named with it):
a change that adds a template flag to a shared tile body leaves the
kernels that do not set it identical.  Needs ``nvcc`` and ``cuobjdump``
(the CUDA toolkit); exits 1 when an old kernel has no identical
counterpart.
"""

from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from crp_tpu_torch.kernels._build import NVCC_FLAGS, nvcc  # noqa: E402

# the library build's flags, to a cubin instead of a shared library
TARGET = tuple(f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC"))


def cubin(src: pathlib.Path, out: pathlib.Path) -> str:
    """Compile ``src`` to ``out``; return ptxas' verbose report."""
    cmd = [nvcc(), *TARGET, "-cubin", "-Xptxas", "-v", "-o", str(out), str(src)]
    got = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return got.stdout + got.stderr


def sass(path: pathlib.Path) -> dict:
    """{mangled kernel name: tuple of its SASS instructions}."""
    tool = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name and m:
            kernels[name].append(m.group(1))
    return {k: tuple(v) for k, v in kernels.items()}


def demangle(names) -> dict:
    tool = os.path.join(os.path.dirname(nvcc()), "cu++filt")
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {n: n for n in names}


def main(argv) -> int:
    old_dir, new_dir = pathlib.Path(argv[0]), pathlib.Path(argv[1])
    stems = argv[2:] or sorted(p.stem for p in old_dir.glob("*.cu")
                               if (new_dir / p.name).exists())
    missing = 0
    got = {"old": {}, "new": {}}  # tag -> stem -> {kernel: SASS}
    with tempfile.TemporaryDirectory() as tmp:
        for stem in stems:
            for tag, d in (("old", old_dir), ("new", new_dir)):
                out = pathlib.Path(tmp) / f"{stem}_{tag}.cubin"
                report = cubin(d / f"{stem}.cu", out)
                regs = re.findall(r"Compiling entry function '(\S+)'.*?Used (\d+) registers",
                                  report, re.S)
                spills = re.findall(r"(\d+) bytes spill stores", report)
                print(f"{stem} {tag}: {len(regs)} kernels, registers "
                      f"{sorted(int(r) for _, r in regs)}, spill stores "
                      f"{sorted(set(int(s) for s in spills))}")
                got[tag][stem] = sass(out)
    # where each body of a tree is, by source
    where = {tag: {} for tag in got}
    for tag, by_stem in got.items():
        for stem, kernels in by_stem.items():
            for body in kernels.values():
                where[tag].setdefault(body, stem)
    for stem in stems:
        print(f"{stem}:")
        old = got["old"][stem]
        names = demangle(list(old))
        here = set(got["new"][stem].values())
        for k, body in old.items():
            found = stem if body in here else where["new"].get(body)
            missing += found is None
            state = ("DIFFERS  " if found is None else "identical")
            moved = "" if found in (None, stem) else f" (now in {found})"
            print(f"  {state} {len(body):5d} instructions  {names[k]}{moved}")
        new = got["new"][stem]
        for k, body in new.items():
            if body not in where["old"]:
                print(f"  new kernel {len(body):5d} instructions  {demangle([k])[k]}")
    return 1 if missing else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
