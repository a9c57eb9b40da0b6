"""Rewrite a ``csrc/*.cu`` source for the CPU emulation in
``cuda_emu.h``: include that header for the CUDA ones, drop the kernels'
inline-PTX helpers (``cp_async16``, ``cp_commit``, ``cp_wait_all``,
``ldsm4``, ``ldsm4t``, ``mma``: the header emulates them), turn each
``extern __shared__`` array into the block's buffer and each
``kernel<<<grid, block, smem, stream>>>(args);`` into an ``emu_launch``.

    python scripts/cuda_emu/prep.py src/.../csrc/x.cu build/cuda_emu/x.cpp
"""
import re
import sys

HELPERS = ("cp_async16", "cp_commit", "cp_wait_all", "ldsm4", "ldsm4t",
           "mma")


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


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        text = prep(f.read())
    with open(sys.argv[2], "w") as f:
        f.write(text)
