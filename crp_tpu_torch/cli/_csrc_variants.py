"""Copies of ``kernels/csrc`` with parts of a kernel edited or compiled
out, built for the card: the shared machinery of ``x3_feed_split`` and
``spill_split``.  The copies go under ``build/crp_tpu_torch/``, never into
``kernels/csrc``."""

from __future__ import annotations

import shutil
import subprocess

from ..kernels import _build


def edited(text: str, edits, tool: str) -> str:
    """``text`` with each ``(anchor, replacement[, count])`` edit made;
    raises where an anchor does not occur ``count`` times (once by
    default)."""
    for anchor, new, *count in edits:
        if text.count(anchor) != (count[0] if count else 1):
            raise ValueError(f"{tool}: anchor not found as expected: {anchor!r}")
        text = text.replace(anchor, new)
    return text


def build(out, jobs: dict, stems, tool: str, refused=None) -> dict:
    """Each job's copy of a source tree, its libraries ``stems`` built by
    one ``nvcc`` each, all started together.  ``jobs`` maps a name to
    ``(source dir, {file name: text replacing that file in the copy},
    macros)``; job i's copy is ``out / f"v{i}"``.  Returns ``{(name, stem):
    library path}``.  A build that fails raises, or, where ``refused`` is a
    dict, is left out and its log kept there under its key."""
    shutil.rmtree(out, ignore_errors=True)
    procs = {}
    for i, (name, (src, texts, macros)) in enumerate(jobs.items()):
        d = out / f"v{i}"
        shutil.copytree(src, d)
        for file, text in texts.items():
            (d / file).write_text(text)
        for stem in stems:
            cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *(f"-D{m}" for m in macros),
                   "-o", str(d / f"{stem}.so"), str(d / f"{stem}.cu")]
            procs[name, stem] = (d / f"{stem}.so", subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = {}
    for key, (_, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            if refused is None:
                raise RuntimeError(f"{tool}: nvcc failed for {key}:\n{log}")
            failed[key] = refused[key] = log
    return {key: path for key, (path, _) in procs.items() if key not in failed}
