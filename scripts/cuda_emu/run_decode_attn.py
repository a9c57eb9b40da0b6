"""Run the decode-attention kernel's CUDA source on the CPU through the CPU
emulation (``cuda_emu.h``) and its real wrapper, and hold it to the plain
version with ``tests/test_torch_decode_attention.py``'s bound (printed as
the worst error over it: under 1 passes), then check that a row's bits do
not change with the batch height or the other rows' positions.

    python scripts/cuda_emu/run_decode_attn.py [--quick]

The library is built with g++ (C++20) into ``build/cuda_emu/``.  The cases
are small versions of the test file's card cases (every CUDA thread is a
host thread): each GQA group shape, head group, head dim route, mask and
cache dtype, with positions on and off the split boundaries.
"""
import sys
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests"),
                str(Path(__file__).resolve().parent)]

from prep import Cuda, build  # noqa: E402
from test_torch_decode_attention import _bound, _inputs, _worst  # noqa: E402

from repro_torch.kernels.decode_attention import \
    decode_attention as wrap  # noqa: E402
from repro_torch.models.attention import decode_attention  # noqa: E402

C = wrap.CHUNK
BF = torch.bfloat16
# (B, H, KH, Smax, hd, window, rolling, kv dtype, positions)
CASES = [(4, 14, 2, 600, 128, None, False, BF, [0, C - 1, C, 599]),
         (2, 4, 4, 300, 128, None, False, BF, [C + 17, 40]),
         (2, 20, 1, 100, 32, None, False, BF, [99, 20]),
         (3, 4, 1, 64, 256, 64, True, BF, [5, 63, 200]),
         (2, 4, 2, 600, 64, 100, False, BF, [90, 599]),
         (2, 2, 2, 100, 112, None, False, BF, [50, 99]),
         (2, 4, 4, 40, 16, None, False, BF, [0, 39]),
         (2, 14, 2, 300, 128, None, False, torch.float8_e4m3fn, [299, 7]),
         (2, 4, 2, 300, 64, None, False, torch.float8_e5m2, [C, 100])]


def run(q, k, v, pos, window=None, rolling=False):
    got = wrap.decode_attn_cuda(*(x.as_subclass(Cuda) for x in (q, k, v,
                                                                 pos)),
                                window, rolling)
    return got.as_subclass(torch.Tensor)


def main(argv):
    so = build("decode_attention")
    wrap.lib = lambda name: so
    wrap._fn.cache_clear()
    torch.cuda.current_stream = \
        lambda d=None: types.SimpleNamespace(cuda_stream=0)
    rng = np.random.default_rng(0)
    ok = True
    for case in CASES[:3] if "--quick" in argv else CASES:
        b, h, kh, smax, hd, window, rolling, kv, positions = case
        q, k, v = _inputs(rng, b, h, kh, smax, hd, kv)
        pos = torch.tensor(positions, dtype=torch.long)
        got = run(q, k, v, pos, window, rolling)
        want = decode_attention(q, k, v, pos, window=window, rolling=rolling)
        worst = _worst(got, want, _bound(q, k, v, pos, want, window,
                                         rolling))
        same = all(torch.equal(run(q[r:r + 1].clone(), k[r:r + 1].clone(),
                                   v[r:r + 1].clone(), pos[r:r + 1].clone(),
                                   window, rolling)[0], got[r])
                   for r in range(b))
        ok &= worst <= 1 and same
        print(f"{case[:8]} pos {positions}: worst {worst:.4f} of the bound,"
              f" rows alone bit-equal {same}", flush=True)
    print("ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
