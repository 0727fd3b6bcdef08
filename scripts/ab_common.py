"""What the kernel A/B scripts (``image_ab.py``, ``env_crop_ab.py``)
share: writing a kernel source's variants beside its text at a git
revision, building them all at once, and reading two checkouts' pools
in turns.  Each script keeps its own variants, timings and pools and
hands them to ``main``.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from typing import Callable

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _who() -> str:
    return os.path.basename(sys.argv[0]).removesuffix(".py")


def patch(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"{_who()}: the source no longer holds {old!r}")
    return text.replace(old, new, 1)


def const(text: str, pattern: str) -> int:
    """The integer that ``pattern``'s ``{}`` stands for in ``text``."""
    return int(re.search(pattern.format(r"(\d+)"), text).group(1))


def source(name: str, ref: str | None = None) -> str:
    """``csrc/<name>`` in the working tree, or at git revision ``ref``."""
    if ref is None:
        return open(os.path.join(CSRC, name)).read()
    return subprocess.run(
        ["git", "show", f"{ref}:src/repro_torch/csrc/{name}"], cwd=ROOT,
        capture_output=True, text=True, check=True).stdout


def make(out: str, ref: str, texts: dict[str, str]) -> None:
    """``DIR/<name>.cu`` for each text, and the checkout at ``ref``
    unpacked into ``DIR/parent_tree`` for ``pools``."""
    os.makedirs(out, exist_ok=True)
    for name, text in texts.items():
        with open(os.path.join(out, name + ".cu"), "w") as f:
            f.write(text)
    tree = os.path.join(out, "parent_tree")
    os.makedirs(tree, exist_ok=True)
    archive = subprocess.run(["git", "archive", ref], cwd=ROOT,
                             capture_output=True, check=True).stdout
    subprocess.run(["tar", "-x", "-C", tree], input=archive, check=True)


def ptxas(log: str, kernels: str) -> dict[str, str]:
    """Each kernel whose name matches ``kernels`` -> its ptxas lines of
    registers and spills."""
    out, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1) if re.search(kernels, m.group(1)) else None
        elif kernel and ("spill" in line or "registers" in line):
            out[kernel] = "; ".join(filter(None, (
                out.get(kernel), line.split(":", 1)[-1].strip())))
            if "registers" in line:
                kernel = None
    return out


def build(out: str, kernels: str,
          bind: Callable[[str, str, ctypes.CDLL], None]) -> dict:
    """Every ``DIR/*.cu`` into a library of its own, one ``nvcc`` each,
    all started together, with ``-Xptxas -v``; prints the registers of
    the kernels matching ``kernels``; ``bind(name, text, lib)`` sets
    each library's argument types."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc

    names = sorted(f[:-3] for f in os.listdir(out) if f.endswith(".cu"))
    procs = {n: subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-shared",
         os.path.join(out, n + ".cu"), "-o", os.path.join(out, n + ".so")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n in names}
    libs = {}
    for n, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"{_who()}: nvcc failed on {n}:\n{log}")
        print(json.dumps({"variant": n, "ptxas": ptxas(log, kernels)}),
              flush=True)
        lib = ctypes.CDLL(os.path.join(out, n + ".so"))
        bind(n, open(os.path.join(out, n + ".cu")).read(), lib)
        libs[n] = lib
    return libs


def pools_one(root: str, label: str, runs: Callable[[], list]) -> None:
    """Device busy ms per recv of each pool of ``runs()`` (task, num_envs,
    batch_size or None, schedule, kernels, transforms or None), twice
    each, from the checkout at ``root``."""
    sys.path.insert(0, root)
    import chip_smoke
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    for task, n, m, schedule, path, transforms in runs():
        busy = [chip_smoke.drive_pool(
            task, n, m, schedule, path, recvs=40,
            transforms=transforms)["device_busy_ms_per_recv"]
            for _ in range(2)]
        print(json.dumps({"tree": label, "task": task, "num_envs": n,
                          "batch_size": m or n,
                          "transforms": transforms is not None,
                          "device_busy_ms_per_recv": busy}), flush=True)


def pools(out: str) -> None:
    """``pools-one`` of ``DIR/parent_tree`` and of this checkout, each in
    its own process, in turns parent, current, current, parent."""
    trees = {"parent": os.path.join(os.path.abspath(out), "parent_tree"),
             "current": ROOT}
    for label in ("parent", "current", "current", "parent"):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(sys.argv[0]), "pools-one",
             trees[label], label], capture_output=True, text=True)
        print("\n".join(line for line in proc.stdout.splitlines()
                        if line.startswith("{\"tree\"")), flush=True)
        if proc.returncode:
            raise SystemExit(f"{_who()}: {label} failed:\n{proc.stderr}")
    sys.path.insert(0, ROOT)
    import chip_smoke
    print(chip_smoke.card_line())


def main(doc: str, make_texts: Callable[[str], dict[str, str]],
         run: Callable[[str], None], runs: Callable[[], list]) -> None:
    """The command line: ``make DIR [REF]`` (``make_texts(REF)`` names
    the variants), ``run DIR``, ``pools DIR``, and ``pools-one ROOT
    LABEL`` (``pools``' own child)."""
    argv = sys.argv
    cmd = argv[1] if len(argv) > 1 else ""
    if cmd == "make" and len(argv) in (3, 4):
        ref = argv[3] if len(argv) == 4 else "HEAD"
        make(argv[2], ref, make_texts(ref))
    elif cmd == "run" and len(argv) == 3:
        run(argv[2])
    elif cmd == "pools" and len(argv) == 3:
        pools(argv[2])
    elif cmd == "pools-one" and len(argv) == 4:
        pools_one(argv[2], argv[3], runs)
    else:
        raise SystemExit(doc)
