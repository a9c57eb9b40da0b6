"""Rewrite a ``csrc/*.cu`` source for the CPU emulation in
``cuda_emu.h``: include that header for the CUDA ones, drop the kernels'
inline-PTX helpers (``cp_async16``, ``cp_commit``, ``cp_wait_all``,
``cp_wait1``, ``ldsm4``, ``ldsm4t``, ``mma``: the header emulates them),
turn each ``extern __shared__`` array into the block's buffer and each
``kernel<<<grid, block, smem, stream>>>(args);`` into an ``emu_launch``.
``build`` does that for a source and compiles it with g++ (C++20) into
``build/cuda_emu/``; ``Cuda`` is a CPU tensor that the wrappers' device
checks take for a CUDA one.

    python scripts/cuda_emu/prep.py src/.../csrc/x.cu build/cuda_emu/x.cpp
"""
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]

HELPERS = ("cp_async16", "cp_commit", "cp_wait_all", "cp_wait1", "ldsm4",
           "ldsm4t", "mma")


def drop_function(src, name):
    m = re.search(r"__device__ __forceinline__ void " + name + r"\(", src)
    if not m:
        return src
    i = j = src.index("{", m.end())
    depth = 0
    while True:
        if src[j] == "{":
            depth += 1
        elif src[j] == "}":
            depth -= 1
            if depth == 0:
                break
        j += 1
    return src[:m.start()] + src[j + 1:]


def split_top(s):
    """s split at its commas outside brackets."""
    out, depth, cur = [], 0, ""
    for ch in s:
        depth += ch in "(<[" and 1 or 0
        depth -= ch in ")>]" and 1 or 0
        if ch == "," and depth == 0:
            out.append(cur)
            cur = ""
        else:
            cur += ch
    return [x.strip() for x in out + [cur]]


def launch(m):
    cfg = split_top(m.group(2)) + ["0"] * 2
    return (f"emu_launch(dim3({cfg[0]}), dim3({cfg[1]}), (size_t)({cfg[2]}),"
            f" (cudaStream_t){cfg[3]}, [&]{{ {m.group(1)}({m.group(3)}); }});")


def prep(src):
    src = src.replace("#include <cuda_bf16.h>", '#include "cuda_emu.h"')
    src = src.replace("#include <cuda_runtime.h>", "")
    for name in HELPERS:
        src = drop_function(src, name)
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* \2 = (\1*)emu_smem;", src)
    return re.sub(r"([\w:]+(?:<[^<>;()]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);",
                  launch, src, flags=re.S)


def build(name) -> ctypes.CDLL:
    """``csrc/<name>.cu`` rewritten, compiled and loaded."""
    out = ROOT / "build" / "cuda_emu"
    out.mkdir(parents=True, exist_ok=True)
    src = ROOT / "src/repro_torch/kernels/csrc" / f"{name}.cu"
    (out / f"{name}.cpp").write_text(prep(src.read_text()))
    lib = out / f"lib{name}.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-w",
                    "-I", str(HERE), "-o", str(lib), str(out / f"{name}.cpp"),
                    "-lpthread"], check=True)
    return ctypes.CDLL(str(lib))


class Cuda(torch.Tensor):
    """A CPU tensor that the wrappers' device checks take for a CUDA one."""

    @property
    def is_cuda(self):
        return True


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        text = prep(f.read())
    with open(sys.argv[2], "w") as f:
        f.write(text)
