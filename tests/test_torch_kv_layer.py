"""The layer-stacked KV state of the port's clustered decode
(``repro_torch.serve.kv_cluster.LayerKVCluster``), its head-batched route
and the decode routine of the centroid attention, on the CPU.

- The layer state of H heads against the per-head API (``OnlineKVCluster``,
  a one-head layer): every head fitted, updated and refreshed as
  ``OnlineKVCluster`` on that head does it, BIT FOR BIT (labels, centers,
  radius, mass, value centroids and radii, v_max, k*, overflow), one row a
  head a step (the decode's, ``index_add_`` sums) and several (sorted
  segment sums): the head-batched route and the flattened EMA keep each
  head's bits;
- the plain head-batched route against a per-head ``predict``, bit for bit,
  ties to the first index;
- the plain decode routine (``ops.flash_centroid_decode`` on the CPU)
  against the reference's ``clustered_attention(q, state, extra_k=,
  extra_v=)`` within 1e-5 relative and absolute (a few float32 ulps of one
  library's sums against the other's), dead and all-dead centroids
  included, and against the port's own ``clustered_attention`` bit for
  bit;
- the decode step's device position: a tensor ``cache_len`` writes and
  attends exactly as the int.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import kv_cluster as jkv
from repro_torch.core.model import build_model, predict
from repro_torch.kernels import ops as tops
from repro_torch.models import model as tm
from repro_torch.models import transformer as tt
from repro_torch.serve import kv_cluster as tkv

# One intra-op thread: the suite runs several workers on the machine's
# cores, and a full torch thread pool in each of them oversubscribes the
# cores and slows the small ops here by two orders of magnitude.
torch.set_num_threads(1)

HD = 16
K_MAX = 16      # a multiple of the CPU's vector width: see _same_bits
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _blobs(rng, n, hkv, k=5):
    """(n, hkv, hd) keys and values, tight blobs per head (the cache
    layout)."""
    keys, vals = [], []
    for _ in range(hkv):
        lab = np.arange(n) % k
        keys.append(4.0 * rng.standard_normal((k, HD))[lab]
                    + 0.05 * rng.standard_normal((n, HD)))
        vals.append(rng.standard_normal((k, HD))[lab]
                    + 0.05 * rng.standard_normal((n, HD)))
    return (np.stack(keys, 1).astype(np.float32),
            np.stack(vals, 1).astype(np.float32))


def _same_bits(layer, heads, what):
    """Row h of the layer state is head h's state, bit for bit. (The
    per-head EMA runs the elementwise ops over K entries, the layer's over
    H·K; with K a multiple of the vector width every entry takes the same
    vectorized path on the CPU.)"""
    for h, cl in enumerate(heads):
        where = f"{what}, head {h}"
        assert layer.k_stars[h] == cl.k_star, where
        assert layer.overflows[h] == cl.overflow, where
        assert layer.refreshes[h] == cl.refreshes, where
        assert layer.pending == cl.pending, where
        for got, want in ((layer.centers[h], cl.model.centers),
                          (layer.radius[h], cl.model.radius),
                          (layer.center_valid[h], cl.model.center_valid),
                          (layer.mass[h], cl.mass),
                          (layer.v_cent[h], cl.v_cent),
                          (layer.v_radius[h], cl.v_radius)):
            assert got.dtype == want.dtype and torch.equal(got, want), where
        assert float(layer.v_max[h]) == cl.v_max, where


@pytest.mark.parametrize("hkv", [2, 4])
@pytest.mark.parametrize("rows", [1, 3])
def test_layer_update_bit_identical_to_per_head(hkv, rows):
    """Fits, updates (``rows`` routed rows a head a step), a refresh, more
    updates: the stacked state equals per-head ``OnlineKVCluster`` runs."""
    rng = np.random.default_rng(hkv * 10 + rows)
    n = 96
    keys, vals = _blobs(rng, n, hkv)
    gcfg = tkv.default_kv_config(K_MAX)
    layer = tkv.LayerKVCluster(hkv, HD, gcfg, ema=0.2, device="cpu",
                               seeds=[(7, 3, h) for h in range(hkv)])
    heads = [tkv.OnlineKVCluster(gcfg, ema=0.2, seed=(7, 3, h), device="cpu")
             for h in range(hkv)]
    layer.start(_t(keys), _t(vals))
    for h, cl in enumerate(heads):
        cl.start(_t(keys[:, h]), _t(vals[:, h]))
    _same_bits(layer, heads, "start")
    assert all(k > 0 for k in layer.k_stars)
    seen_k, seen_v = [keys], [vals]
    for step in range(8):
        if step == 4:           # a refresh between the updates
            all_k, all_v = (np.concatenate(a) for a in (seen_k, seen_v))
            assert layer.refresh(_t(all_k), _t(all_v)) is True
            for h, cl in enumerate(heads):
                assert cl.refresh(_t(all_k[:, h]), _t(all_v[:, h])) is True
            _same_bits(layer, heads, "refresh")
        nk = (keys[rng.integers(0, n, rows)]
              + 0.3 * rng.standard_normal((rows, hkv, HD))).astype(np.float32)
        nv = (vals[rng.integers(0, n, rows)]
              + 0.3 * rng.standard_normal((rows, hkv, HD))).astype(np.float32)
        seen_k.append(nk)
        seen_v.append(nv)
        got = layer.update(_t(nk.transpose(1, 0, 2)),
                           _t(nv.transpose(1, 0, 2)))
        assert got.shape == (hkv, rows) and got.dtype == torch.int32
        for h, cl in enumerate(heads):
            want = cl.update(_t(nk[:, h]), _t(nv[:, h]))
            assert torch.equal(got[h], want), f"step {step}, head {h}"
        _same_bits(layer, heads, f"step {step}")
    for h, cl in enumerate(heads):
        assert layer.error_bound(h, 1.5) == cl.error_bound(1.5)
        lab, dist = predict(layer.head_model(h), _t(keys[:, h]))
        want_lab, want_dist = cl.route(_t(keys[:, h])), predict(
            cl.model, _t(keys[:, h]))[1]
        assert torch.equal(lab, want_lab) and torch.equal(dist, want_dist)


def test_layer_refresh_with_nothing_pending_is_a_noop():
    keys, vals = _blobs(np.random.default_rng(3), 64, 2)
    layer = tkv.LayerKVCluster(2, HD, tkv.default_kv_config(K_MAX),
                               device="cpu")
    layer.start(_t(keys), _t(vals))
    before = [t.clone() for t in (layer.centers, layer.radius, layer.mass,
                                  layer.v_cent, layer.v_radius)]
    storage = layer.centers.data_ptr()
    assert layer.refresh(_t(keys), _t(vals)) is False
    assert layer.refreshes == [0, 0]
    assert all(torch.equal(b, a) for b, a in zip(
        before, (layer.centers, layer.radius, layer.mass, layer.v_cent,
                 layer.v_radius)))
    layer.update(_t(keys[:1].transpose(1, 0, 2)),
                 _t(vals[:1].transpose(1, 0, 2)))
    assert layer.refresh(_t(keys), _t(vals)) is True
    assert layer.centers.data_ptr() == storage      # written in place
    with pytest.raises(ValueError, match="ema"):
        tkv.LayerKVCluster(2, HD, ema=0.0, device="cpu")
    with pytest.raises(ValueError, match="probes"):
        tkv.LayerKVCluster(2, HD, probes=-1, device="cpu")
    assert tkv.LayerKVCluster(2, HD, probes=2, device="cpu").probed_heads() \
        == []                                       # no fit yet
    with pytest.raises(ValueError, match="seeds"):
        tkv.LayerKVCluster(2, HD, seeds=[(0,)], device="cpu")


def test_per_head_view_before_and_after_start():
    """``OnlineKVCluster`` before ``start``: no model, no state, a refresh
    is a no-op; after it, a view of row 0 of a one-head layer, whose
    storage a refresh keeps."""
    keys, vals = _blobs(np.random.default_rng(5), 64, 1)
    cl = tkv.OnlineKVCluster(tkv.default_kv_config(K_MAX), seed=(1, 2),
                             device="cpu")
    assert cl.model is None and cl.mass is None and cl.layer is None
    assert (cl.k_star, cl.overflow, cl.pending, cl.refreshes, cl.v_max) == (
        0, 0, 0, 0, 0.0)
    assert cl.refresh(keys[:, 0], vals[:, 0]) is False
    cl.start(keys[:, 0], vals[:, 0])                 # numpy rows
    assert cl.layer.num_heads == 1 and cl.layer.seeds == [(1, 2)]
    storage = cl.layer.centers.data_ptr()
    cl.update(_t(keys[:2, 0]), _t(vals[:2, 0]))
    assert cl.pending == 2 and cl.refresh(keys[:, 0], vals[:, 0]) is True
    assert cl.refreshes == 1 and cl.layer.centers.data_ptr() == storage
    assert torch.equal(cl.model.centers, cl.layer.centers[0])
    assert cl.v_max == float(cl.layer.v_max[0]) > 0.0


@pytest.mark.parametrize("hkv,n,k,d", [(2, 1, 16, 16), (8, 1, 64, 64),
                                       (3, 37, 70, 24)])
def test_head_batched_route_matches_per_head_predict(hkv, n, k, d):
    """The plain head-batched route (the kernel's CPU path) equals one
    ``predict`` per head bit for bit, duplicated centers tying to the
    first index within each head."""
    rng = np.random.default_rng(hkv + n + k)
    x = rng.standard_normal((hkv, n, d)).astype(np.float32)
    c = rng.standard_normal((hkv, k, d)).astype(np.float32)
    c[:, 5] = c[:, 2]                           # a tie: label 2, never 5
    x[:, 0] = c[:, 2] + 1e-3
    valid = rng.random((hkv, k)) < 0.8
    valid[:, [2, 5]] = True
    valid[-1] = False                           # a head with no valid center
    tx, tc, tv = _t(x), _t(c), _t(valid)
    csq = torch.sum(tc * tc, dim=-1)
    labels, d2 = tops.distance_argmin_l2_heads(tx, tc, csq, tv)
    assert labels.shape == d2.shape == (hkv, n)
    for h in range(hkv):
        model = build_model(tc[h], tv[h], torch.tensor(int(valid[h].sum())),
                            torch.zeros(k), metric="l2")
        lab, dist = predict(model, tx[h])
        assert torch.equal(labels[h], lab), h
        assert torch.equal(torch.sqrt(d2[h]), dist), h
    assert int(labels[0, 0]) == 2
    assert not bool(labels[-1].any())           # no valid center: label 0


def _decode_case(case, rng, B=1, hq=4, hkv=2, K=12):
    c = rng.standard_normal((hkv, K, HD)).astype(np.float32)
    v = rng.standard_normal((hkv, K, HD)).astype(np.float32)
    mass = rng.integers(0, 5, (hkv, K)).astype(np.float32)
    valid = rng.random((hkv, K)) < 0.7
    if case == "live":
        mass += 1.0
        valid[:] = True
    elif case == "all_dead":
        valid[:] = False
    q = rng.standard_normal((B, 1, hq, HD)).astype(np.float32)
    ek, ev = (rng.standard_normal((B, 1, hkv, HD)).astype(np.float32)
              for _ in range(2))
    return q, c, v, mass, valid, ek, ev


@pytest.mark.parametrize("case", ["live", "dead", "all_dead"])
@pytest.mark.parametrize("extras", [True, False])
def test_decode_routine_plain_matches_reference(case, extras):
    """The decode routine's plain version against the reference's
    ``clustered_attention`` on the log-mass of ``head_state``'s rule: some
    centroids dead by validity and some by zero mass, or all dead (with the
    fresh row: its value; without: the mean of the value centroids)."""
    rng = np.random.default_rng(len(case) + 10 * extras)
    q, c, v, mass, valid, ek, ev = _decode_case(case, rng, B=2)
    live = valid & (mass > 0)
    lm = np.where(live, np.log(np.maximum(mass, 1e-9)), -1e30)
    lm = lm.astype(np.float32)
    kw = {"extra_k": ek, "extra_v": ev} if extras else {}
    want = np.asarray(jkv.clustered_attention(
        jnp.asarray(q), jkv.KVState(*map(jnp.asarray, (c, v, lm))),
        **{k: jnp.asarray(a) for k, a in kw.items()}))
    got = tops.flash_centroid_decode(_t(q), _t(c), _t(v), _t(mass),
                                     _t(valid),
                                     **{k: _t(a) for k, a in kw.items()})
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    same = tkv.clustered_attention(
        _t(q), tkv.KVState(_t(c), _t(v), _t(lm)),
        **{k: _t(a) for k, a in kw.items()})
    assert torch.equal(got, same)
    if case == "all_dead":
        g = q.shape[2] // c.shape[0]
        mean = ev[:, 0] if extras else np.broadcast_to(v.mean(1), ev[:, 0].shape)
        np.testing.assert_allclose(got.numpy()[:, 0],
                                   np.repeat(mean, g, axis=1), **TOL)


def test_decode_routine_keeps_the_query_dtype():
    rng = np.random.default_rng(4)
    q, c, v, mass, valid, ek, ev = _decode_case("dead", rng)
    qb, ekb, evb = (_t(a).bfloat16() for a in (q, ek, ev))
    got = tops.flash_centroid_decode(qb, _t(c), _t(v), _t(mass), _t(valid),
                                     extra_k=ekb, extra_v=evb)
    want = tops.flash_centroid_decode(qb.float(), _t(c), _t(v), _t(mass),
                                      _t(valid), extra_k=ekb.float(),
                                      extra_v=evb.float())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())


def test_tensor_position_writes_and_attends_as_the_int():
    """``decode_step`` with the position as a device tensor (the captured
    step's input) gives the int's logits and cache, bit for bit."""
    import repro_torch as rt
    cfg = dataclasses.replace(rt.get_arch("qwen3_0_6b", smoke=True),
                              num_layers=2, dtype="float32")
    params = rt.init_params(cfg, 0, device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (1, 12),
                        generator=torch.Generator().manual_seed(0))
    runs = []
    for pos in (10, torch.tensor([10])):
        caches = tt.stack_cache_init(cfg, 1, 12, "cpu")
        tm.forward(params, cfg, tok[:, :10], caches=caches, cache_len=0)
        logits, caches = tm.decode_step(params, cfg, caches, pos,
                                        tok[:, 10:11])
        runs.append((logits, caches))
    (la, ca), (lb, cb) = runs
    assert torch.equal(la, lb)
    for a, b in zip(ca, cb):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
