"""The decode-attention dispatcher and its CUDA kernel.

On the CPU the dispatcher takes the plain version
(``models.attention.decode_attention``) bit for bit and counts no launch;
``impl="cuda"`` on a CPU tensor raises, and the wrapper's argument checks
raise before any launch (tensors that pass its device check are CPU
tensors of a subclass whose ``is_cuda`` is True).

On the card (``cuda`` marker, skipped without a GPU) the kernel is held
to the plain version in bf16 on the same inputs, within ``_bound``.  With
u = 2^-8 (bf16's unit roundoff: a rounding moves a value by at most 2^-8
of itself) and p the plain version's probabilities, each version rounds
its output to bf16 once (u |out|) and each probability to bf16 where it
meets V (the kernel before the division by the row's sum, the plain
version after it: u sum_i p_i |v_i| in all), and sums at most Smax terms
in f32 (Smax 2^-24 sum_i p_i |v_i|).  So the two may differ by
2^-7 |out| + (2^-7 + Smax 2^-23) sum_i p_i |v_i|.  A row's output is
bit-identical at every batch height and whatever the other rows'
positions; a graph replayed at moved positions equals the eager call; a
served run launches it once per attention layer and step, and no CUDA
tensor reaches the plain version.  This file does
not import JAX: the plain version is the oracle.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention import decode_attention as wrap
from repro_torch.models import attention, lm

F8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def _inputs(rng, b, h, kh, smax, hd, kv_dtype=torch.bfloat16,
            device="cpu"):
    q = torch.from_numpy(rng.standard_normal((b, 1, h, hd)).astype(
        np.float32)).to(torch.bfloat16)
    k, v = (torch.from_numpy(rng.standard_normal((b, smax, kh, hd)).astype(
        np.float32)).to(kv_dtype) for _ in range(2))
    return q.to(device), k.to(device), v.to(device)


# ------------------------------------------------------------- the CPU

# (B, H, KH, Smax, hd, window, rolling, kv dtype): GQA groups of 1, 4 and
# 7, a window, a rolling ring, fp8 caches
CPU_CASES = [(3, 4, 4, 40, 16, None, False, torch.bfloat16),
             (3, 8, 2, 40, 32, None, False, torch.bfloat16),
             (3, 14, 2, 40, 16, None, False, torch.bfloat16),
             (3, 8, 2, 40, 16, 6, False, torch.bfloat16),
             (3, 8, 2, 8, 16, 8, True, torch.bfloat16),
             (3, 14, 2, 40, 16, None, False, torch.float8_e4m3fn),
             (3, 4, 1, 8, 16, 8, True, torch.float8_e5m2)]
_CPU_IDS = ["group1", "group4", "group7", "window", "rolling", "fp8-e4m3",
            "fp8-e5m2-rolling"]


@pytest.mark.parametrize("case", CPU_CASES, ids=_CPU_IDS)
def test_cpu_routes_to_the_plain_version(rng, case):
    b, h, kh, smax, hd, window, rolling, kv = case
    q, k, v = _inputs(rng, b, h, kh, smax, hd, kv)
    pos = torch.tensor([0, smax // 2, 3 * smax])[:b]
    reset_launches()
    got = ops.decode_attention(q, k, v, pos, window=window, rolling=rolling)
    want = attention.decode_attention(q, k, v, pos, window=window,
                                      rolling=rolling)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert LAUNCHES["decode_attn"] == 0


def test_cpu_decode_step_counts_no_launch():
    """A whole decode step on the CPU (dense and whisper's cross
    attention) takes the plain version."""
    reset_launches()
    for arch in ("yi-34b-smoke", "whisper-base-smoke"):
        cfg = get_arch(arch)
        params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
        state = lm.init_cache(cfg, 2, 16, device="cpu")
        logits, _ = lm.decode_step(params, state,
                                   torch.ones((2, 1), dtype=torch.long), cfg)
        assert torch.isfinite(logits).all()
    assert LAUNCHES["decode_attn"] == 0


def test_impl_cuda_on_a_cpu_tensor_raises(rng):
    q, k, v = _inputs(rng, 2, 4, 2, 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(q, k, v, torch.zeros(2, dtype=torch.long),
                             impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.decode_attention(q, k, v, torch.zeros(2, dtype=torch.long),
                             impl="triton")


class _Cuda(torch.Tensor):
    """A CPU tensor that the wrapper's device check takes for a CUDA one."""

    @property
    def is_cuda(self):
        return True


def _bad_args(rng):
    """Each refused call: its arguments and what the error names."""
    q, k, v = _inputs(rng, 2, 4, 2, 16, 16)
    pos = torch.zeros(2, dtype=torch.long)

    def three(x):                        # 3 KV heads
        return x[:, :, :1].expand(2, 16, 3, 16).contiguous()

    return {
        "q-float32": ((q.float(), k, v, pos, None), "bfloat16"),
        "q-two-tokens": ((q.expand(2, 2, 4, 16).contiguous(), k, v, pos,
                          None), r"\[B,1,H,hd\]"),
        "hd-12": ((q[..., :12].contiguous(), k[..., :12].contiguous(),
                   v[..., :12].contiguous(), pos, None), "multiple of 8"),
        "cache-float32": ((q, k.float(), v.float(), pos, None), "share"),
        "k-v-dtypes": ((q, k, v.to(F8[0]), pos, None), "share"),
        "kv-heads-3-of-4": ((q, three(k), three(v), pos, None), "KH"),
        "v-length": ((q, k, v[:, :8].contiguous(), pos, None), "v must"),
        "k-batch": ((q, k[:1].contiguous(), v[:1].contiguous(), pos, None),
                    "k must"),
        "pos-int32": ((q, k, v, pos.int(), None), "int64"),
        "pos-one-row": ((q, k, v, pos[:1], None), "pos must"),
        "k-not-contiguous": ((q, k.transpose(1, 2).contiguous()
                              .transpose(1, 2), v, pos, None), "contiguous"),
        "q-not-contiguous": ((torch.cat([q, q], -1)[..., ::2], k, v, pos,
                              None), "contiguous"),
        "window-0": ((q, k, v, pos, 0), "window"),
        "v-not-contiguous": ((q, k, v.transpose(1, 2).contiguous()
                              .transpose(1, 2), pos, None), "contiguous"),
    }


BAD = ["q-float32", "q-two-tokens", "hd-12", "cache-float32", "k-v-dtypes",
       "kv-heads-3-of-4", "v-length", "k-batch", "pos-int32", "pos-one-row",
       "k-not-contiguous", "q-not-contiguous", "window-0",
       "v-not-contiguous"]


@pytest.mark.parametrize("name", BAD)
def test_wrapper_refuses_bad_arguments(rng, name):
    args, match = _bad_args(rng)[name]
    args = tuple(a.as_subclass(_Cuda) if isinstance(a, torch.Tensor) else a
                 for a in args)
    reset_launches()
    with pytest.raises(ValueError, match=match):
        wrap.decode_attn_cuda(*args)
    assert LAUNCHES["decode_attn"] == 0


def test_scratch_size_counts_each_split():
    # yi: 8 rows, 56 heads, 3088 positions in 13 splits of 256, hd 128
    assert wrap.scratch_floats(8, 56, 3088, 128) == 8 * 56 * 13 * 130
    assert wrap.scratch_floats(1, 4, wrap.CHUNK, 16) == 4 * 18


# --------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _bound(q, k, v, pos, want, window=None, rolling=False):
    """The sum of both versions' rounding bounds (the module docstring):
    sum_i p_i |v_i| is the plain version's f32 softmax applied to |V| (q
    handed over as its bf16 scaling rounded it)."""
    hd = q.shape[-1]
    qs = (q * hd ** -0.5).float() * hd ** 0.5
    pv = attention.decode_attention(qs, k.float(), v.float().abs(), pos,
                                    window=window, rolling=rolling)
    return 2.0 ** -7 * want.float().abs() + \
        (2.0 ** -7 + k.shape[1] * 2.0 ** -23) * pv


def _worst(got, want, bound) -> float:
    """The largest error over its bound (an exact output, which an fp8
    cache's zeros give, reads 0 where its bound is 0)."""
    err = (got.float() - want.float()).abs()
    return float(torch.where(err == 0, 0.0, err / bound).max())


def _check(got, want, bound, what=""):
    assert got.dtype == want.dtype and got.shape == want.shape
    worst = _worst(got, want, bound)
    assert worst <= 1.0, f"{what}: {worst:.3f} of the bound"


C = wrap.CHUNK
# yi's decode shape at positions on and off the split boundaries
YI_POS = [0, C - 1, C, 1500, 3087, 2 * C + 1, 3000, 17]
# (B, H, KH, Smax, hd, window, rolling, kv dtype, positions): yi at 8 rows;
# olmoe (group 1); qwen2-vl (7 over 4) at hd 128; starcoder2 (9), command-r
# (12), qwen3 (16) groups; two head groups (20 of one KV head); gemma3's
# rolling ring of 1024 at hd 256 (group 4) before and after it wraps, and a
# plain window; zamba2's hd 112; the smoke models' hd 16; whisper's self
# attention and its cross attention over 1500 frames at hd 64; yi's heads
# split over 2 and 4 shards; fp8 caches
GPU_CASES = [(8, 56, 8, 3088, 128, None, False, torch.bfloat16, YI_POS),
             (4, 16, 16, 700, 128, None, False, torch.bfloat16,
              [0, 300, 699, 511]),
             (3, 28, 4, 600, 128, None, False, torch.bfloat16, [5, 256, 599]),
             (2, 36, 4, 520, 128, None, False, torch.bfloat16, [519, 100]),
             (2, 96, 8, 300, 128, None, False, torch.bfloat16, [299, 1]),
             (2, 64, 4, 300, 128, None, False, torch.bfloat16, [299, 40]),
             (2, 20, 1, 300, 64, None, False, torch.bfloat16, [299, 70]),
             (4, 4, 1, 1024, 256, 1024, True, torch.bfloat16,
              [0, 1023, 1024, 5000]),
             (3, 8, 2, 2000, 64, 300, False, torch.bfloat16,
              [100, 1299, 1999]),
             (3, 32, 32, 400, 112, None, False, torch.bfloat16, [0, 200, 399]),
             (3, 4, 4, 96, 16, None, False, torch.bfloat16, [0, 50, 95]),
             (3, 4, 1, 8, 16, 8, True, torch.bfloat16, [3, 7, 20]),
             (2, 8, 8, 448, 64, None, False, torch.bfloat16, [10, 447]),
             (4, 8, 8, 1500, 64, None, False, torch.bfloat16, [1499] * 4),
             (8, 28, 4, 3088, 128, None, False, torch.bfloat16, YI_POS),
             (8, 14, 2, 3088, 128, None, False, torch.bfloat16, YI_POS),
             (8, 56, 8, 3088, 128, None, False, torch.float8_e4m3fn, YI_POS),
             (3, 56, 8, 700, 128, None, False, torch.float8_e5m2,
              [0, 300, 699]),
             (3, 4, 1, 1024, 256, 1024, True, torch.float8_e4m3fn,
              [10, 1023, 3000])]
_GPU_IDS = ["yi-8rows", "olmoe-group1", "qwen2vl-group7", "starcoder2-group9",
            "commandr-group12", "qwen3-group16", "two-head-groups",
            "gemma3-rolling-hd256", "window", "zamba2-hd112", "smoke-hd16",
            "smoke-rolling-hd16", "whisper-self-hd64", "whisper-cross-1500",
            "yi-tp2-shard", "yi-tp4-shard", "yi-fp8-e4m3", "fp8-e5m2",
            "gemma3-fp8-rolling"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GPU_CASES, ids=_GPU_IDS)
def test_kernel_matches_plain_version(cuda, rng, case):
    b, h, kh, smax, hd, window, rolling, kv, positions = case
    q, k, v = _inputs(rng, b, h, kh, smax, hd, kv, cuda)
    pos = torch.tensor(positions, dtype=torch.long, device=cuda)
    reset_launches()
    got = ops.decode_attention(q, k, v, pos, window=window, rolling=rolling)
    assert LAUNCHES["decode_attn"] == 1
    want = attention.decode_attention(q, k, v, pos, window=window,
                                      rolling=rolling)
    bound = _bound(q, k, v, pos, want, window, rolling)
    torch.cuda.synchronize()
    for r in range(b):
        _check(got[r], want[r], bound[r], f"row {r} pos {positions[r]}")


@pytest.mark.cuda
def test_expanded_positions_equal_contiguous_ones(cuda, rng):
    """A caller may hand every row one position as an expanded scalar (the
    block-level checks do); the wrapper copies it, nothing else."""
    q, k, v = _inputs(rng, 4, 8, 2, 300, 64, device=cuda)
    pos = torch.tensor(123, device=cuda)
    got = ops.decode_attention(q, k, v, pos.expand(4))
    assert torch.equal(got, ops.decode_attention(q, k, v, pos.repeat(4)))


@pytest.mark.cuda
def test_row_bits_do_not_depend_on_height_or_other_rows(cuda, rng):
    q, k, v = _inputs(rng, 8, 56, 8, 3088, 128, device=cuda)
    pos = torch.tensor(YI_POS, dtype=torch.long, device=cuda)
    full = ops.decode_attention(q, k, v, pos)
    for rows in (1, 2, 4):
        part = ops.decode_attention(q[:rows].clone(), k[:rows].clone(),
                                    v[:rows].clone(), pos[:rows].clone())
        assert torch.equal(part, full[:rows]), rows
    moved = pos.clone()
    moved[1:] = torch.tensor([3087, 0, 5, 2000, 1, 256, 255], device=cuda)
    again = ops.decode_attention(q, k, v, moved)
    assert torch.equal(again[0], full[0])
    # a cache twice as long gives the same bits where the positions fit
    k2, v2 = (torch.cat([x, torch.randn_like(x.float()).to(x.dtype)], 1)
              for x in (k, v))
    longer = ops.decode_attention(q, k2, v2, pos)
    assert torch.equal(longer, full)


@pytest.mark.cuda
def test_graph_replay_at_moved_positions_equals_eager(cuda, rng):
    q, k, v = _inputs(rng, 8, 56, 8, 3088, 128, device=cuda)
    pos = torch.tensor(YI_POS, dtype=torch.long, device=cuda)
    ops.decode_attention(q, k, v, pos)        # the first launch, eagerly
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention(q, k, v, pos)
    for moved in (YI_POS, [3087] * 8, [1, 2, 3, 600, 700, 800, 2999, 64]):
        pos.copy_(torch.tensor(moved, device=cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ops.decode_attention(q, k, v, pos)), moved


@pytest.mark.cuda
def test_served_run_launches_once_per_layer_and_step(cuda, monkeypatch):
    """Every decode attention of a served run goes through the kernel:
    layers x (replays + each capture's eager warm-up step) launches, and
    the plain version sees no CUDA tensor."""
    from repro_torch.engine import ServeEngine

    def plain_on_cpu_only(q, *a, **kw):
        assert not q.is_cuda, "a CUDA tensor reached the plain version"
        return attention.decode_attention(q, *a, **kw)

    monkeypatch.setattr(ops, "plain", plain_on_cpu_only)
    cfg = get_arch("yi-34b-smoke")
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    eng = ServeEngine(cfg, params, max_len=64, slots=4, prefill_chunk=8,
                      decode_chunk=2, device=cuda)
    reset_launches()
    reqs = [eng.submit(rng.integers(1, cfg.vocab, (n,)).astype(np.int32),
                       max_new=m) for n, m in ((5, 9), (12, 3), (3, 12))]
    eng.run_until_done()
    assert all(len(r.output()) for r in reqs)
    graphs = eng._tick.graphs.values()
    assert graphs and all(g.per_replay["decode_attn"] == cfg.num_layers
                          for g in graphs)
    assert LAUNCHES["decode_attn"] == sum(
        (g.replays + 1) * g.per_replay["decode_attn"] for g in graphs)
