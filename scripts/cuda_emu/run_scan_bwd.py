"""Run a scan backward's CUDA source on the CPU through the CPU emulation
(``cuda_emu.h``) and its real wrapper, and hold every gradient to the
plain backward with ``chip_smoke.py`` ``check_scan_bwd``'s gate (printed
as the worst error over its bound: under 1 passes).

    python scripts/cuda_emu/run_scan_bwd.py mamba2 B H T P N [--f32] [--no-state]
    python scripts/cuda_emu/run_scan_bwd.py rwkv6 B H T N [--f32] [--no-state]

The library is built with g++ (C++20) into ``build/cuda_emu/``; the
inputs are ``tests/test_torch_scan_grad.py``'s (the models' layouts and
ranges, seed 0).  A small shape takes seconds: every CUDA thread is a host
thread.
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
from test_torch_scan_grad import mamba_inputs, rwkv_inputs  # noqa: E402


def worst(got, want):
    """The largest error over check_scan_bwd's bound, by gradient."""
    out = []
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        g = g.as_subclass(torch.Tensor)
        assert g.dtype == w.dtype and g.shape == w.shape
        ulp = 2.0 ** -7 if g.dtype == torch.bfloat16 else 1e-4
        w = w.float()
        bound = ulp * w.abs() + 1e-4 * w.abs().max()
        out.append(((g.float() - w).abs() / bound).max().item()
                   if w.numel() else 0.0)
    return out


def main(argv):
    kind, dims = argv[0], [int(x) for x in argv[1:] if x.isdigit()]
    dtype = torch.float32 if "--f32" in argv else torch.bfloat16
    rng = np.random.default_rng(0)
    torch.cuda.current_stream = \
        lambda d=None: types.SimpleNamespace(cuda_stream=0)
    if kind == "mamba2":
        from repro_torch.kernels.mamba2_ssd import mamba2_ssd as mod
        from repro_torch.kernels.mamba2_ssd.ref import mamba2_bwd_ref as ref
        ins, dy, ds = mamba_inputs(rng, *dims)
        x, dt, a, bm, c, d, s0 = ins
        x, bm, c, dy = (z.to(dtype) for z in (x, bm, c, dy))
        args = [x, dt, a, bm, c, d, dy]
        fn, lib = "mamba2_bwd_cuda", "mamba2_ssd_bwd"
    else:
        from repro_torch.kernels.rwkv6_scan import rwkv6_scan as mod
        from repro_torch.kernels.rwkv6_scan.ref import rwkv6_bwd_ref as ref
        ins, dy, ds = rwkv_inputs(rng, *dims)
        r, k, v, w, u, s0 = ins
        r, k, v, w, dy = (z.to(dtype) for z in (r, k, v, w, dy))
        args = [r, k, v, w, u, dy]
        fn, lib = "rwkv6_bwd_cuda", "rwkv6_scan_bwd"
    if "--no-state" in argv:
        s0 = ds = None
    args += [s0, ds]
    so = build(lib)
    mod.lib = lambda name: so
    mod._bwd_fn.cache_clear()
    got = getattr(mod, fn)(*(None if z is None else z.as_subclass(Cuda)
                             for z in args))
    ratios = worst(got, ref(*args))
    print(f"{kind} {dims} {dtype}: worst error over the gate's bound by "
          f"gradient {[round(x, 4) for x in ratios]}")
    return 0 if max(ratios) <= 1 else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
