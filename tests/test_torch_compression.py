"""int8 gradient compression (``optim/compression.py``) against the JAX
package's: ``quantize``, ``dequantize`` and ``compress_tree`` on the same
leaves, and ``quantized_psum`` at world 2 and 4, the port under ``gloo``
(one process a rank) against the reference inside its ``shard_map`` over
forced host devices (the harness of ``tests/test_torch_sharded_moe.py``).

Held exactly: the int8 codes, the scales and the dequantized values of
``quantize``/``compress_tree`` (``torch.round`` and ``jnp.round`` both
round half to even, and both divide, then multiply by 127, in the leaf's
dtype), and the int32 sums of ``quantized_psum``'s codes, recovered from
its outputs with the shared scale.  Its f32 outputs and residuals are held
within two ulps of the decode: inside ``jit`` XLA rounds ``a / 127`` and
the products with it otherwise than eager code does (by one ulp here),
where the codes and scales are the same.  The leaves include a tensor of
exact halves, where rounding to even matters, and an all-zero leaf (its
scale clamped at 1e-12 to encode).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.optim import compression as j_comp
from repro_torch.optim import compression as comp

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLDS = (2, 4)


def leaves(seed, rank=0):
    """A small gradient tree and its residual for one rank: f32 normals,
    a bf16 leaf, codes at exact halves, and zeros."""
    rng = np.random.default_rng(seed + 100 * rank)
    halves = (np.arange(-8, 9) + 0.5).astype(np.float32) / 127.0 * 8.5
    grads = {"a": rng.standard_normal((4, 5)).astype(np.float32),
             "b": {"c": (3 * rng.standard_normal(7)).astype(np.float32),
                   "z": np.zeros(3, np.float32)},
             "h": halves}
    res = {"a": (1e-3 * rng.standard_normal((4, 5))).astype(np.float32),
           "b": {"c": np.zeros(7, np.float32), "z": np.zeros(3, np.float32)},
           "h": np.zeros_like(halves)}
    return grads, res


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix: np.asarray(tree.numpy() if torch.is_tensor(tree)
                               else tree)}


def test_quantize_and_dequantize_match_reference(rng):
    g = rng.standard_normal(1000).astype(np.float32)
    g[:17] = (np.arange(-8, 9) + 0.5) / 127.0 * np.abs(g).max()
    for scale in (None, 2.5):
        jq, ja = j_comp.quantize(jnp.asarray(g), scale)
        q, a = comp.quantize(torch.from_numpy(g), scale)
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(a) == float(ja)
        np.testing.assert_array_equal(
            comp.dequantize(q, a).numpy(),
            np.asarray(j_comp.dequantize(jq, ja)))
    q, a = comp.quantize(torch.zeros(5))
    assert float(a) == float(np.float32(1e-12)) and not q.any()
    bf = torch.from_numpy(g[:64]).to(torch.bfloat16)
    jq, _ = j_comp.quantize(jnp.asarray(bf.float().numpy()).astype(
        jnp.bfloat16))
    np.testing.assert_array_equal(comp.quantize(bf)[0].numpy(),
                                  np.asarray(jq))


def test_compress_tree_matches_reference(suite_seed):
    g, r = leaves(suite_seed)
    jt = j_comp.compress_tree(jax.tree.map(jnp.asarray, g),
                              jax.tree.map(jnp.asarray, r))
    tt = comp.compress_tree(_torch(g), _torch(r))
    for j_part, t_part in zip(jt, tt):
        j_flat, t_flat = _flat(jax.tree.map(np.asarray, j_part)), \
            _flat(t_part)
        assert j_flat.keys() == t_flat.keys()
        for key in j_flat:
            np.testing.assert_array_equal(t_flat[key], j_flat[key])
    # error feedback: dequantized codes plus the residual give g + r
    recon = comp.dequantize(tt[0]["a"], tt[1]["a"]) + tt[2]["a"]
    np.testing.assert_allclose(recon.numpy(), g["a"] + r["a"], atol=1e-6)


REFERENCE = textwrap.dedent('''
    import sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    sys.path.insert(0, sys.argv[3])
    import test_torch_compression as t
    from repro.optim.compression import quantized_psum
    seed, out = int(sys.argv[1]), sys.argv[2]
    res = {}
    for world in (2, 4):
        trees = [t.leaves(seed, r) for r in range(world)]
        stack = lambda i: jax.tree.map(lambda *xs: jnp.stack(xs),
                                       *[tr[i] for tr in trees])
        mesh = jax.make_mesh((world,), ("data",),
                             devices=jax.devices()[:world])
        def body(g, r):
            g = jax.tree.map(lambda x: x[0], g)
            r = jax.tree.map(lambda x: x[0], r)
            o, nr = quantized_psum(g, r, ("data",))
            return (jax.tree.map(lambda x: x[None], o),
                    jax.tree.map(lambda x: x[None], nr))
        f = jax.jit(jax.shard_map(body, mesh=mesh,
                                  in_specs=(P("data"), P("data")),
                                  out_specs=(P("data"), P("data"))))
        o, nr = f(stack(0), stack(1))
        for name, tree in (("out", o), ("res", nr)):
            for k, v in t._flat(jax.tree.map(np.asarray, tree)).items():
                res[f"{world}/{name}/{k}"] = v
    np.savez(out, **res)
''')


def _env(**kw):
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC, os.path.dirname(__file__), os.environ.get("PYTHONPATH", "")]),
        JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", **kw)


def worker(rank, world, tmp, seed):
    """One rank: ``quantized_psum`` of its own tree over the world."""
    import torch.distributed as dist
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init_{world}",
                            rank=rank, world_size=world)
    try:
        g, r = leaves(int(seed), rank)
        out, res = comp.quantized_psum(_torch(g), _torch(r))
        flat = {f"out/{k}": v for k, v in _flat(out).items()}
        flat.update({f"res/{k}": v for k, v in _flat(res).items()})
        np.savez(os.path.join(tmp, f"port_{world}_{rank}.npz"), **flat)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, suite_seed):
    tmp = tmp_path_factory.mktemp("compression")
    procs = [subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(suite_seed),
         str(tmp / "ref.npz"), os.path.dirname(__file__)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)]
    for world in WORLDS:
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 "import sys, test_torch_compression as t; "
                 "t.worker(*sys.argv[1:])", str(rank), str(world),
                 str(tmp), str(suite_seed)],
                env=_env(), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT))
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out.decode()[-3000:]
    ref = dict(np.load(tmp / "ref.npz"))
    port = {w: [dict(np.load(tmp / f"port_{w}_{r}.npz")) for r in range(w)]
            for w in WORLDS}
    return ref, port


@pytest.mark.parametrize("world", WORLDS)
def test_quantized_psum_matches_reference(runs, suite_seed, world):
    """The summed codes exactly, the summed tree (the same on every rank)
    and each rank's residual within two ulps of the decode."""
    ref, port = runs
    trees = [leaves(suite_seed, r) for r in range(world)]
    # the shared scale of each leaf: the largest |g + r| over the ranks
    scale = {k: max(np.abs(_flat(g)[k] + _flat(r)[k]).max()
                    for g, r in trees) for k in _flat(trees[0][0])}
    ulps = 2.0 ** -22
    for rank, got in enumerate(port[world]):
        for key, v in got.items():
            want = ref[f"{world}/{key}"][rank]
            leaf = key.split("/", 1)[1]
            step = np.float32(max(scale[leaf], 1e-12)) / np.float32(127)
            if key.startswith("out/"):
                np.testing.assert_array_equal(np.rint(v / step),
                                              np.rint(want / step), key)
                np.testing.assert_allclose(v, want, rtol=ulps, atol=0,
                                           err_msg=key)
                np.testing.assert_array_equal(v, port[world][0][key])
            else:
                np.testing.assert_allclose(v, want, rtol=0,
                                           atol=ulps * 127 * step,
                                           err_msg=key)


def test_quantized_psum_on_one_rank_is_compress_tree(suite_seed):
    """Without a process group the sum is this rank's own dequantized
    codes and the residual compress_tree's."""
    g, r = leaves(suite_seed)
    out, res = comp.quantized_psum(_torch(g), _torch(r))
    q, a, res2 = comp.compress_tree(_torch(g), _torch(r))
    for key, v in _flat(out).items():
        np.testing.assert_array_equal(
            v, _flat(comp.tree_map(comp.dequantize, q, a))[key])
    for key, v in _flat(res).items():
        np.testing.assert_array_equal(v, _flat(res2)[key])
