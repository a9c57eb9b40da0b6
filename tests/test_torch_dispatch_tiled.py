"""The tiled rank of the CUDA MoE dispatch (``csrc/moe_dispatch.cu``),
written out in numpy, against the port's ``dispatch_ref`` and the JAX
package's ``dispatch_pallas`` (interpret mode).

The kernel ranks a group's flat ``T*k`` assignments (in ``t*k + j`` order)
in tiles of ``TILE`` assignments, one block per tile, in two passes:

* pass A: each tile's histogram of keys, the key being the slot, or S for
  an invalid assignment or a slot outside ``[0, S)``;
* pass B: a tile's base per key is the sum of the histograms of the
  earlier tiles of its group; inside the tile, each warp of 32 assignments
  adds the counts of the earlier warps (prefix over per-warp histograms),
  and each lane the number of lanes below it with its key (the warp's
  ``__match_any_sync`` mask under the lanes below, ``__popc``).  The
  rank is that sum; ``routed`` is the sum over all tiles, ``kept =
  min(routed, C)``, ``keep = valid and rank < C``, rank 0 where invalid.

This is the stable-argsort rank: ranks, keeps and counts must equal the
references exactly.  The buffer is rebuilt from the ranks as the kernel
writes it (each kept assignment's row ``w * v`` rounded once, every other
row zero) and must equal ``dispatch_ref``'s bit for bit.

A slot outside ``[0, S)`` counts as invalid in the kernel (routing never
produces one); the references index by it, so they are given the same
assignment marked invalid.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.moe_dispatch.moe_dispatch import dispatch_pallas
from repro_torch.kernels.moe_dispatch.moe_dispatch import TILE
from repro_torch.kernels.moe_dispatch.ref import dispatch_ref

WARP = 32
_j_dispatch = jax.jit(dispatch_pallas, static_argnums=(4, 5, 6))


def dispatch_tiled(v, w, slot, valid, n_slots, cap, tile=TILE):
    """The kernel's passes; v [G,T,D] f32; w [G,T,k] f32; slot/valid
    [G,T,k] i32 (numpy).  Returns (buf, rank, keep, routed, kept) as
    ``dispatch_ref`` does."""
    g, t, d = v.shape
    k = slot.shape[-1]
    n = t * k
    fs, fv = slot.reshape(g, n), valid.reshape(g, n) != 0
    vld = fv & (fs >= 0) & (fs < n_slots)
    key = np.where(vld, fs, n_slots)
    n_tiles = -(-n // tile)
    # pass A: one histogram of S + 1 keys per tile
    hist = np.zeros((g, n_tiles, n_slots + 1), np.int64)
    for gi in range(g):
        for ti in range(n_tiles):
            hist[gi, ti] = np.bincount(key[gi, ti * tile:(ti + 1) * tile],
                                       minlength=n_slots + 1)
    # pass B
    rank = np.zeros((g, n), np.int64)
    for gi in range(g):
        for ti in range(n_tiles):
            pre = hist[gi, :ti].sum(0)           # the earlier tiles' counts
            for w0 in range(ti * tile, min((ti + 1) * tile, n), WARP):
                lanes = key[gi, w0:min(w0 + WARP, n)]
                below = np.array([np.sum(lanes[:i] == lanes[i])
                                  for i in range(len(lanes))])
                rank[gi, w0:w0 + len(lanes)] = pre[lanes] + below
                pre = pre + np.bincount(lanes, minlength=n_slots + 1)
    routed = hist.sum(1)[:, :n_slots]
    kept = np.minimum(routed, cap)
    keep = vld & (rank < cap)
    rank = np.where(vld, rank, 0)
    buf = np.zeros((g, n_slots, cap, d), np.float32)
    for gi, a in zip(*np.nonzero(keep)):
        buf[gi, fs[gi, a], rank[gi, a]] = np.float32(
            w.reshape(g, n)[gi, a]) * v[gi, a // k]
    return (buf, rank.reshape(g, t, k).astype(np.int32),
            keep.reshape(g, t, k).astype(np.int32), routed.astype(np.int32),
            kept.astype(np.int32))


def _routing(rng, g, t, k, s, hot, p_valid, out_of_range):
    if hot:          # most assignments in slot 1, far over capacity
        slot = np.where(rng.random((g, t, k)) < 0.8, 1,
                        rng.integers(0, s, (g, t, k)))
    else:
        slot = rng.integers(0, s, (g, t, k))
    if out_of_range:
        bad = rng.random((g, t, k)) < 0.05
        slot = np.where(bad, rng.choice([-1, s, s + 3], (g, t, k)), slot)
    valid = rng.random((g, t, k)) < p_valid
    return slot.astype(np.int32), valid.astype(np.int32)


@pytest.mark.parametrize("g,t,k,s,cap,tile,hot,p_valid,out_of_range", [
    (1, 300, 2, 18, 40, 256, True, 1.0, False),    # 600: tiles 256+256+88
    (2, 256, 2, 18, 40, 256, False, 0.9, False),   # tiles divide T*k
    (1, 150, 4, 10, 30, 64, True, 0.8, True),      # many tiles, ragged
    (3, 7, 2, 6, 4, 256, False, 0.7, True),        # one short tile a group
    (1, 1024, 2, 18, 160, TILE, True, 1.0, False)])
def test_tiled_rank_matches_references(rng, g, t, k, s, cap, tile, hot,
                                       p_valid, out_of_range):
    d = 16
    v = rng.standard_normal((g, t, d)).astype(np.float32)
    w = rng.random((g, t, k)).astype(np.float32)
    slot, valid = _routing(rng, g, t, k, s, hot, p_valid, out_of_range)
    got = dispatch_tiled(v, w, slot, valid, s, cap, tile)
    # the references see an out-of-range slot as an invalid assignment
    oob = (slot < 0) | (slot >= s)
    r_slot = np.where(oob, 0, slot).astype(np.int32)
    r_valid = np.where(oob, 0, valid).astype(np.int32)
    ref = dispatch_ref(*(torch.from_numpy(x) for x in (v, w, r_slot,
                                                       r_valid)), s, cap)
    for name, a, b in zip(("buf", "rank", "keep", "routed", "kept"), got,
                          ref):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    if hot:
        assert got[4].sum() < got[3].sum()       # over capacity: drops
    for gi in range(g):
        pb = _j_dispatch(jnp.asarray(v[gi]), jnp.asarray(w[gi]),
                         jnp.asarray(r_slot[gi]), jnp.asarray(r_valid[gi]),
                         s, cap, t)
        for name, a, b in zip(("rank", "keep", "routed", "kept"),
                              (x[gi] for x in got[1:]), pb[1:]):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
        np.testing.assert_allclose(got[0][gi], np.asarray(pb[0]), atol=1e-5)
