"""The decode step's absorb of one attention layer
(``repro_torch.serve.kv_cluster.LayerKVCluster.absorb`` with one new key
and value a kv head, ``ops.l2_absorb_heads``) against the reference's
route and EMA (``repro.core.model.predict`` on each head's model, then
``repro.serve.kv_cluster.ema_update``), on the CPU, where the absorb takes
its plain path (the head-batched route, then one EMA over the heads).

The state is the decode's shape, 8 kv heads of 64 centroids in 64 dims,
with dead rows (one of them equal to its head's key), a head with no
valid center (label 0, as ``predict`` gives it), an exact tie between two
valid centers (the first wins) and a hit on a head's last row. Labels are
held equal; the updated floats within 1e-5 relative and absolute, the
tolerance of ``test_ema_update_matches_reference_and_keeps_unhit_bits``
(a few float32 ulps of one library's sums and norms against the
other's); the clusters no key lands in keep their bits. The kernel
itself is held to this path on the card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.model import build_model as j_build_model
from repro.core.model import predict as j_predict
from repro.serve import kv_cluster as jkv
from repro_torch.kernels import distance_argmin as tda
from repro_torch.serve import kv_cluster as tkv

torch.set_num_threads(1)

H, K, D = 8, 64, 64
EMA = 0.1
TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = ("centers", "v_cent", "radius", "v_radius", "mass", "center_valid",
         "v_max")


def _case(seed):
    """(keys (H, 1, D), values (H, 1, D), state by name) in numpy."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((H, K, D)).astype(np.float32)
    vc = rng.standard_normal((H, K, D)).astype(np.float32)
    valid = rng.random((H, K)) < 0.8
    keys = rng.standard_normal((H, 1, D)).astype(np.float32)
    values = rng.standard_normal((H, 1, D)).astype(np.float32)
    c[0, 5] = c[0, 2]                           # a tie: label 2, never 5
    valid[0, [2, 5]] = True
    keys[0, 0] = c[0, 2] + 0.01 * rng.standard_normal(D)
    valid[1, K - 1] = True                      # a hit on the last row
    keys[1, 0] = c[1, K - 1] + 0.01 * rng.standard_normal(D)
    valid[:, 7] = False                         # a dead row at the key
    c[:, 7] = keys[:, 0]
    valid[H - 1] = False                        # no valid center: label 0
    mass = np.where(valid, rng.integers(1, 600, (H, K)), 0).astype(
        np.float32)
    state = {"centers": c, "v_cent": vc,
             "radius": 3 * rng.random((H, K)).astype(np.float32),
             "v_radius": 3 * rng.random((H, K)).astype(np.float32),
             "mass": mass, "center_valid": valid,
             "v_max": 4 * rng.random(H).astype(np.float32)}
    return keys, values, state


def _reference(keys, values, state):
    """Per head: the reference's predict labels, then its ema_update."""
    labels, out = [], {n: state[n].copy() for n in NAMES}
    for h in range(H):
        model = j_build_model(jnp.asarray(state["centers"][h]),
                              jnp.asarray(state["center_valid"][h]),
                              jnp.asarray(int(state["center_valid"][h].sum())),
                              jnp.asarray(state["radius"][h]), metric="l2")
        lab, _ = j_predict(model, jnp.asarray(keys[h]))
        new = jkv.ema_update(*(jnp.asarray(state[n][h]) for n in (
            "centers", "radius", "mass", "v_cent", "v_radius")),
            jnp.asarray(keys[h]), jnp.asarray(values[h]), lab, ema=EMA)
        for n, a in zip(("centers", "radius", "mass", "v_cent", "v_radius"),
                        new):
            out[n][h] = np.asarray(a)
        out["v_max"][h] = max(state["v_max"][h],
                              float(np.linalg.norm(values[h, 0])))
        labels.append(np.asarray(lab))
    return np.stack(labels), out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_absorb_plain_path_matches_reference_route_and_ema(seed, dtype):
    """``LayerKVCluster.absorb`` of one row a head on the CPU against the
    reference per head; keys and values handed as the step hands them
    (strided views of one projection, in the model's dtype)."""
    keys, values, state = _case(seed)
    rows = torch.from_numpy(np.concatenate([keys, values], 0)).to(dtype)
    rows = rows.transpose(0, 1)[None].contiguous()      # (1, 1, 2H, D)
    tk, tv = (rows[0, :, s].transpose(0, 1) for s in (slice(0, H),
                                                      slice(H, 2 * H)))
    keys, values = (t.float().numpy() for t in (tk, tv))
    state["centers"][:, 7] = keys[:, 0]         # the dead row at the key
    layer = tkv.LayerKVCluster(H, D, tkv.default_kv_config(K), ema=EMA,
                               device="cpu")
    for n in NAMES:
        getattr(layer, n).copy_(torch.from_numpy(state[n]))
    got = layer.absorb(tk, tv)
    want, ref = _reference(keys, values, state)
    assert got.shape == (H, 1) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[0, 0]) == 2 and int(got[1, 0]) == K - 1
    assert int(got[H - 1, 0]) == 0
    assert not bool(layer.center_valid[torch.arange(H), got[:, 0]][:-1]
                    .logical_not().any())           # never a dead row
    hit = np.zeros((H, K), bool)
    hit[np.arange(H), want[:, 0]] = True
    for n in NAMES:
        g = getattr(layer, n).numpy()
        np.testing.assert_allclose(g, ref[n], **TOL, err_msg=n)
        if n != "v_max":
            np.testing.assert_array_equal(g[~hit], state[n][~hit],
                                          err_msg=n)


def test_absorb_kernel_wrapper_refuses_cpu_tensors_and_batches():
    keys, values, state = _case(0)
    st = [torch.from_numpy(state[n]) for n in NAMES]
    csq = torch.sum(st[0] * st[0], dim=-1)
    decay = torch.pow(1.0 - EMA, torch.ones(1))
    tk, tv = torch.from_numpy(keys), torch.from_numpy(values)
    before = tda.l2_absorb_heads.launches
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        tda.l2_absorb_heads(tk, tv, *st, csq, decay)
    two = torch.cat([tk, tk], 1)
    with pytest.raises(ValueError, match=r"\(H, 1, d\)"):
        tda.l2_absorb_heads(two, two, *st, csq, decay)
    assert tda.l2_absorb_heads.launches == before
