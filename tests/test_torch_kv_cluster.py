"""The port's online KV-cache clustering (``repro_torch.serve.kv_cluster``)
against the reference's (``repro.serve.kv_cluster``), on the CPU.

Both packages get the same numpy keys, values and queries. Fits draw as
the parity contract says: the port's ``draws`` hook hands each fit the
reference's JAX-drawn arrays (``jax_draws`` of
``fold_in(head key, fit number)``), so the integer stages (buckets, SILK
seeds, k*) are equal and the float stages are held within tolerance.

Tolerances, with their reasons:

- attention, EMA and value statistics: 1e-5 relative and absolute, a few
  float32 ulps of one library's sums and norms against the other's;
- fitted centers and value statistics: the same, and labels equal except
  at near-ties, which are counted and named (``_torch_parity``);
- fitted radii: squared, within 1e-5 of max‖x‖² + max‖c‖², since both
  packages take them from the assignment's expansion ‖x‖² − 2x·c + ‖c‖²,
  which rounds at that scale (the near-tie rule's scale); the error bound,
  which grows with the key radius, within 1e-3 relative for that reason;
- whole decodes (a 2-layer float32 smoke LM): k* equal per head, the
  perplexity within 1e-4 relative: the models agree to ~1e-6, and the
  clustered steps add centroid sums of the same order.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import InjectedBucketer, assert_labels_match, carrier, \
    jax_draws
from repro.configs import get_arch as j_get_arch
from repro.models import model as JM
from repro.serve import kv_cluster as jkv
from repro_torch.core.model import (build_center_index, build_model,
                                    predict, update_centers)
from repro_torch.kernels.pack import pack_codes
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import kv_cluster as tkv

# One intra-op thread: the suite runs several workers on the machine's
# cores, and a full torch thread pool in each of them oversubscribes the
# cores and slows the small ops here by two orders of magnitude.
torch.set_num_threads(1)

HD = 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _injected(key, hd: int, jcfg):
    """The port's ``draws`` hook: fit f gets the reference's draws for
    ``fold_in(key, f)``."""
    def draws(fits):
        a, keys = jax_draws(jax.random.fold_in(key, fits), hd, jcfg)
        return InjectedBucketer(a=torch.from_numpy(np.array(a)),
                                table_keys=carrier(keys))
    return draws


def _blobs(n=384, hd=HD, k=6, seed=0):
    """Tight key and value blobs (both radii small, the bound useful)."""
    rng = np.random.default_rng(seed)
    lab = np.arange(n) % k
    keys = 4.0 * rng.standard_normal((k, hd))[lab] + \
        0.05 * rng.standard_normal((n, hd))
    values = rng.standard_normal((k, hd))[lab] + \
        0.05 * rng.standard_normal((n, hd))
    return keys.astype(np.float32), values.astype(np.float32)


def _state(rng, hkv, K, dead=0):
    lm = np.log1p(rng.random((hkv, K))).astype(np.float32)
    if dead:
        lm[:, K - dead:] = -1e30
    return (rng.standard_normal((hkv, K, HD)).astype(np.float32),
            rng.standard_normal((hkv, K, HD)).astype(np.float32), lm)


def _exact_attention(q, keys, values):
    """Exact per-key attention in float64 numpy (non-causal)."""
    s = np.float64(q) @ np.float64(keys).T / math.sqrt(q.shape[-1])
    w = np.exp(s - s.max(axis=-1, keepdims=True))
    return (w / w.sum(axis=-1, keepdims=True)) @ np.float64(values)


# ---------------------------------------------------------------------------
# clustered attention, EMA, value statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["gqa", "extras", "dead", "all_dead"])
def test_clustered_attention_matches_reference(case):
    rng = np.random.default_rng(len(case))
    B, S, hq, hkv, K = (2, 5, 4, 2, 12) if case == "gqa" else (2, 1, 4, 2, 10)
    dead = {"dead": 5, "all_dead": K}.get(case, 0)
    c, v, lm = _state(rng, hkv, K, dead)
    q = rng.standard_normal((B, S, hq, HD)).astype(np.float32)
    extra = {}
    if case != "gqa":
        extra = {name: rng.standard_normal((B, S, hkv, HD)).astype(np.float32)
                 for name in ("extra_k", "extra_v")}
    want = np.asarray(jkv.clustered_attention(
        jnp.asarray(q), jkv.KVState(*map(jnp.asarray, (c, v, lm))),
        **{k: jnp.asarray(a) for k, a in extra.items()}))
    for use_flash in (False, True):      # metadata: the device decides
        got = tkv.clustered_attention(
            _t(q), tkv.KVState(*map(_t, (c, v, lm))),
            **{k: _t(a) for k, a in extra.items()}, use_flash=use_flash)
        assert got.shape == (B, S, hq, HD)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="S == 1"):
        tkv.clustered_attention(_t(np.zeros((B, 2, hq, HD), np.float32)),
                                tkv.KVState(*map(_t, (c, v, lm))),
                                extra_k=torch.zeros(B, 2, hkv, HD),
                                extra_v=torch.zeros(B, 2, hkv, HD))


@pytest.mark.parametrize("seed", range(4))
def test_ema_update_matches_reference_and_keeps_unhit_bits(seed):
    """Several rows per cluster, some clusters unhit: the reference's
    values, and the unhit clusters returned bit for bit."""
    rng = np.random.default_rng(seed)
    K, n = 9, 7
    c, v = (rng.standard_normal((K, 8)).astype(np.float32) for _ in range(2))
    r, vr, m = (np.abs(rng.standard_normal(K)).astype(np.float32)
                for _ in range(3))
    keys, vals = (rng.standard_normal((n, 8)).astype(np.float32)
                  for _ in range(2))
    lab = rng.integers(0, K - 3, n).astype(np.int32)
    args = (c, r, m, v, vr, keys, vals, lab)
    want = jkv.ema_update(*map(jnp.asarray, args), ema=0.3)
    got = tkv.ema_update(*map(_t, args), ema=0.3)
    hit = np.zeros(K, bool)
    hit[lab] = True
    for g, w, old in zip(got, want, (c, r, m, v, vr)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        np.testing.assert_array_equal(g.numpy()[~hit], old[~hit])
    assert float((got[2] - _t(m)).sum()) == pytest.approx(n)
    # one row: the closed form c <- (1 - ema) c + ema k
    one = tkv.ema_update(*map(_t, (c, r, m, v, vr, keys[:1], vals[:1],
                                   lab[:1])), ema=0.25)
    np.testing.assert_allclose(one[0][lab[0]].numpy(),
                               0.75 * c[lab[0]] + 0.25 * keys[0], **TOL)


def test_value_stats_match_reference():
    rng = np.random.default_rng(5)
    lab = rng.integers(0, 6, 200).astype(np.int32)
    vals = rng.standard_normal((200, HD)).astype(np.float32)
    valid = np.arange(8) < 6
    want = jkv._value_stats(jnp.asarray(lab), jnp.asarray(vals),
                            jnp.asarray(valid))
    got = tkv._value_stats(_t(lab), _t(vals), _t(valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# ---------------------------------------------------------------------------
# OnlineKVCluster: start, update, refresh, no-op refresh, error bound
# ---------------------------------------------------------------------------

def _fit_ties(jcl, tcl, keys, what):
    """Right after a fit: the fit labels (``predict`` on the fit rows)
    equal except at near-ties, counted and named. Returns the clusters a
    near-tie row lands in on either side: their mass, value statistics and
    radius legitimately differ."""
    jl, tl = np.asarray(jcl.route(keys)), tcl.route(_t(keys)).numpy()
    assert_labels_match(keys, tcl.model.centers.numpy(),
                        tcl.model.center_valid.numpy(), jl, tl, what)
    touched = np.zeros(tcl.gcfg.k_max, bool)
    touched[jl[jl != tl]] = touched[tl[jl != tl]] = True
    np.testing.assert_array_equal(tcl.mass.numpy(), np.bincount(
        tl, minlength=tcl.gcfg.k_max))
    return touched


def _same_head(jcl, tcl, what, keys, touched):
    """The two heads agree, but for the value side and radius of the
    ``touched`` clusters; ``keys`` (rows both have seen) set the scale of
    the radii's rounding."""
    assert tcl.k_star == jcl.k_star, what
    assert tcl.pending == jcl.pending and tcl.refreshes == jcl.refreshes
    valid = tcl.model.center_valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(jcl.model.center_valid))
    np.testing.assert_allclose(tcl.model.centers.numpy(),
                               np.asarray(jcl.model.centers), **TOL,
                               err_msg=what)
    keep = ~touched
    for g, w in ((tcl.mass, jcl.mass), (tcl.v_cent, jcl.v_cent),
                 (tcl.v_radius, jcl.v_radius)):
        np.testing.assert_allclose(g.numpy()[keep], np.asarray(w)[keep],
                                   **TOL, err_msg=what)
    c = tcl.model.centers.numpy()[valid]
    scale = float((keys ** 2).sum(1).max() + (c ** 2).sum(1).max())
    np.testing.assert_allclose(tcl.model.radius.numpy()[keep] ** 2,
                               np.asarray(jcl.model.radius)[keep] ** 2,
                               rtol=0, atol=1e-5 * scale, err_msg=what)
    assert tcl.v_max == pytest.approx(jcl.v_max, rel=1e-6)


@pytest.fixture(scope="module")
def heads():
    """One head fitted by each package on the same blobs, the port fed the
    reference's draws (module-scoped: the reference's fit compiles)."""
    keys, values = _blobs()
    gcfg = jkv.default_kv_config(16)
    key = jax.random.PRNGKey(7)
    jcl = jkv.OnlineKVCluster(gcfg, key=key)
    jcl.start(jnp.asarray(keys), jnp.asarray(values))
    tcl = tkv.OnlineKVCluster(tkv.default_kv_config(16),
                              draws=_injected(key, HD, gcfg), device="cpu")
    tcl.start(_t(keys), _t(values))
    return jcl, tcl, keys, values


def test_start_update_refresh_match_reference(heads):
    jcl, tcl, keys, values = heads
    touched = _fit_ties(jcl, tcl, keys, "start")
    _same_head(jcl, tcl, "start", keys, touched)
    assert 0 < tcl.k_star <= 16 and tcl.overflow == 0
    rng = np.random.default_rng(11)
    nk = (keys[:4] + 0.1 * rng.standard_normal((4, HD))).astype(np.float32)
    nv = (values[:4] + 0.1 * rng.standard_normal((4, HD))).astype(np.float32)
    for i in range(4):                   # one routed row per step, as decode
        lab_j = jcl.update(jnp.asarray(nk[i:i + 1]), jnp.asarray(nv[i:i + 1]))
        lab_t = tcl.update(_t(nk[i:i + 1]), _t(nv[i:i + 1]))
        np.testing.assert_array_equal(lab_t.numpy(), np.asarray(lab_j))
    _same_head(jcl, tcl, "after 4 updates", keys, touched)
    all_k, all_v = np.concatenate([keys, nk]), np.concatenate([values, nv])
    assert jcl.refresh(jnp.asarray(all_k), jnp.asarray(all_v)) is True
    assert tcl.refresh(_t(all_k), _t(all_v)) is True
    touched = _fit_ties(jcl, tcl, all_k, "refresh")
    _same_head(jcl, tcl, "refresh", all_k, touched)
    assert tcl.error_bound(1.0) == pytest.approx(jcl.error_bound(1.0),
                                                 rel=1e-3)
    state = tkv.stack_heads([tcl, tcl])
    assert state.centers.shape == (2, 16, HD) and state.log_mass.shape == (2, 16)
    live = state.log_mass[0] > -1e29
    assert torch.equal(live, tcl.model.center_valid & (tcl.mass > 0))
    assert float(state.log_mass[0][live].exp().sum()) == pytest.approx(
        len(all_k), rel=1e-5)


def test_refresh_with_nothing_pending_is_a_noop():
    keys, values = _blobs(n=96, hd=8, seed=3)
    cl = tkv.OnlineKVCluster(tkv.default_kv_config(8), seed=(5, 1),
                             device="cpu")
    cl.start(_t(keys), _t(values))
    before = [t.clone() for t in (cl.model.centers, cl.model.radius, cl.mass,
                                  cl.v_cent, cl.v_radius)]
    assert cl.refresh(_t(keys), _t(values)) is False and cl.refreshes == 0
    after = (cl.model.centers, cl.model.radius, cl.mass, cl.v_cent,
             cl.v_radius)
    assert all(torch.equal(b, a) for b, a in zip(before, after))


def test_error_bound_holds():
    """‖exact − clustered‖₂ ≤ r_v + (e^{2ε}−1)·v_max on structured KV,
    right after the fit and after streaming updates (radii grow)."""
    keys, values = _blobs(seed=1)
    cl = tkv.OnlineKVCluster(tkv.default_kv_config(16), seed=3, device="cpu")
    cl.start(_t(keys), _t(values))
    rng = np.random.default_rng(9)
    q = rng.standard_normal((1, 8, 1, HD)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    bound = cl.error_bound(1.0)
    got = tkv.clustered_attention(_t(q), tkv.stack_heads([cl]))[0, :, 0]
    err = np.linalg.norm(got.numpy() - _exact_attention(q[0, :, 0], keys,
                                                        values), axis=-1)
    assert np.all(np.isfinite(err)) and float(err.max()) <= bound + 1e-6
    assert bound < float(np.linalg.norm(values, axis=-1).max())
    lab0 = cl.route(_t(keys)).numpy()
    absorbed = [(keys, lab0)]
    for i in range(8):
        nk = (3.0 * rng.standard_normal((1, HD))).astype(np.float32)
        absorbed.append((nk, cl.update(_t(nk), _t(nk)).numpy()))
    centers, radius = cl.model.centers.numpy(), cl.model.radius.numpy()
    for pts, lab in absorbed:
        d = np.linalg.norm(pts - centers[lab], axis=-1)
        assert np.all(d <= radius[lab] + 1e-4)


def test_update_centers_rederives_and_refuses_the_index():
    keys, values = _blobs(n=128, hd=8, seed=4)
    cl = tkv.OnlineKVCluster(tkv.default_kv_config(8), device="cpu")
    cl.start(_t(keys), _t(values))
    model = cl.model
    moved = update_centers(model, model.centers + 0.5)
    q = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (32, 8)).astype(np.float32))
    lab, _ = predict(moved, q)
    c = np.where(moved.center_valid.numpy()[:, None], moved.centers.numpy(),
                 np.inf)
    d = np.linalg.norm(q.numpy()[:, None] - c[None], axis=-1)
    np.testing.assert_array_equal(lab.numpy(), d.argmin(axis=1))
    with pytest.raises(ValueError, match="centers"):
        update_centers(model, model.centers[:, :-1])
    # the index stays as fitted unless asked, then is rebuilt from the
    # new centers (the center index was refused here before it was ported)
    assert model.index_tables > 0
    assert moved.center_index is model.center_index
    rebuilt = update_centers(model, model.centers + 0.5, rebuild_index=True)
    fresh = build_center_index(model.centers + 0.5, model.center_valid,
                               metric="l2", tables=model.index_tables,
                               bucket=model.index_bucket)
    assert torch.equal(rebuilt.center_index.sorted_ids, fresh.sorted_ids)
    assert torch.equal(rebuilt.center_index.sorted_keys, fresh.sorted_keys)
    no_index = dataclasses.replace(model, index_tables=0)
    assert update_centers(no_index, model.centers, rebuild_index=True) \
        .index_tables == 0
    codes = torch.randint(0, 16, (8, 5), dtype=torch.int32)
    ham = build_model(codes, torch.ones(8, dtype=torch.bool),
                      torch.tensor(8), torch.zeros(8), metric="hamming",
                      impl="packed", code_bits=4)
    new = (codes + 1) % 16
    assert torch.equal(update_centers(ham, new).packed_centers,
                       pack_codes(new, 4))


def test_route_probed_threshold():
    """probes engage only once a fit finds k* >= probe_min_k; then the
    route is the model's probed predict, else the exact one."""
    keys, values = _blobs(n=256, hd=8, k=8, seed=6)
    gcfg = tkv.default_kv_config(16)
    lo = tkv.OnlineKVCluster(gcfg, probes=1, probe_min_k=10 ** 6,
                             device="cpu")
    lo.start(_t(keys), _t(values))
    want, _ = predict(lo.model, _t(keys[:40]))
    assert lo.layer.probed_heads() == []
    assert torch.equal(lo.route(keys[:40]), want)
    hi = tkv.OnlineKVCluster(gcfg, probes=0, probe_min_k=1, device="cpu")
    hi.start(_t(keys), _t(values))
    assert hi.layer.probed_heads() == [0]
    want, _ = predict(hi.model, _t(keys[:40]), probes=0)
    assert torch.equal(hi.route(keys[:40]), want)


@pytest.mark.parametrize("mixed", [False, True])
def test_layer_probed_absorb_routes_then_drifts(mixed):
    """A layer whose heads route through their indexes (all, or all but
    head 1, whose k* is set below probe_min_k) absorbs as routing then
    one EMA: with each window as wide as k_max the probed labels are the
    exact ones, so the state is the exact-routed layer's, bit for bit."""
    rng = np.random.default_rng(int(mixed))
    H, hd, n = 3, 8, 96
    keys = np.stack([_blobs(n=n, hd=hd, k=2 + 2 * h, seed=h)[0]
                     for h in range(H)], axis=1)               # (n, H, hd)
    gcfg = tkv.default_kv_config(8)
    lays = [tkv.LayerKVCluster(H, hd, gcfg, probes=p, probe_min_k=2,
                               device="cpu") for p in (None, 1)]
    for lay in lays:
        lay.start(_t(keys), _t(keys))
    if mixed:
        lays[1].k_stars[1] = 1
    assert lays[1].probed_heads() == ([0, 2] if mixed else [0, 1, 2])
    new = _t(keys[:5].transpose(1, 0, 2)
             + 0.01 * rng.standard_normal((H, 5, hd)).astype(np.float32))
    for rows in (new, new[:, :1]):
        got = [lay.update(rows, rows) for lay in lays]
        assert torch.equal(got[0], got[1])
        for name in ("centers", "radius", "mass", "v_cent", "v_radius",
                     "v_max"):
            assert torch.equal(getattr(lays[0], name),
                               getattr(lays[1], name)), name


def test_constructor_validation():
    with pytest.raises(ValueError, match="ema"):
        tkv.OnlineKVCluster(ema=0.0, device="cpu")
    with pytest.raises(ValueError, match="ema"):
        tkv.OnlineKVCluster(ema=1.5, device="cpu")
    with pytest.raises(ValueError, match="probes"):
        tkv.OnlineKVCluster(probes=-1, device="cpu")
    assert tkv.OnlineKVCluster(probes=2, device="cpu").probe_min_k == 256
    assert tkv.OnlineKVCluster(device="cpu").k_star == 0
    assert tkv.fit_seed(1, 2, 3) == tkv.fit_seed(1, 2, 3) != \
        tkv.fit_seed(1, 2, 4)


# ---------------------------------------------------------------------------
# the decode harness
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tiny():
    cfg = dataclasses.replace(j_get_arch("smollm_360m", smoke=True),
                              num_layers=2, dtype="float32", remat=False)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (1, 60), 0,
                                           cfg.vocab_size))
    return cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                      device="cpu"), tokens


def test_clustered_decode_matches_reference(monkeypatch):
    """Both modes, the port fed the reference's draws head by head: k*
    equal per head, refreshes equal, perplexities within 1e-4."""
    cfg, jp, tp, tokens = _tiny()
    jheads = []
    init = jkv.OnlineKVCluster.__init__

    def recording_init(self, *a, **kw):
        init(self, *a, **kw)
        jheads.append(self)

    monkeypatch.setattr(jkv.OnlineKVCluster, "__init__", recording_init)
    gcfg, key = jkv.default_kv_config(16), jax.random.PRNGKey(2)
    knobs = dict(refresh_every=6)

    def draws(layer, h, fits):
        head_key = jax.random.fold_in(key, layer * 1024 + h)
        return _injected(head_key, cfg.resolved_head_dim, gcfg)(fits)

    for mode in ("exact", "clustered"):
        want = jkv.clustered_decode(jp, cfg, jnp.asarray(tokens), 48,
                                    mode=mode, gcfg=gcfg, key=key, **knobs)
        got = tkv.clustered_decode(tp, cfg, tokens, 48, mode=mode,
                                   gcfg=tkv.default_kv_config(16),
                                   draws=draws, device="cpu", **knobs)
        assert got["steps"] == want["steps"] == 12
        assert got["ppl"] == pytest.approx(want["ppl"], rel=1e-4), mode
        assert got["nll"] == pytest.approx(math.log(got["ppl"]))
        assert len(got["seconds"]["steps"]) == 12
    assert got["k_stars"] == [cl.k_star for cl in jheads]
    assert 0 < min(got["k_stars"]) and got["overflows"] == [0, 0]
    assert got["refreshes"] == want["refreshes"] == 2
    assert got["mean_k_star"] == want["mean_k_star"]
    assert got["compression"] == pytest.approx(want["compression"])


def test_clustered_decode_own_draws_and_validation():
    cfg, _, tp, tokens = _tiny()
    out = tkv.clustered_decode(tp, cfg, tokens, 48, device="cpu",
                               gcfg=tkv.default_kv_config(8), refresh_every=6)
    again = tkv.clustered_decode(tp, cfg, tokens, 48, device="cpu",
                                 gcfg=tkv.default_kv_config(8),
                                 refresh_every=6)
    assert out["ppl"] == again["ppl"] and out["k_stars"] == again["k_stars"]
    assert math.isfinite(out["ppl"]) and out["compression"] > 1.0
    assert "mean_k_star" not in tkv.clustered_decode(tp, cfg, tokens, 48,
                                                     mode="exact",
                                                     device="cpu")
    with pytest.raises(ValueError, match="single-sequence"):
        tkv.clustered_decode(tp, cfg, np.zeros((2, 8), np.int32), 4,
                             device="cpu")
    with pytest.raises(ValueError, match="mode"):
        tkv.clustered_decode(tp, cfg, tokens, 48, mode="???", device="cpu")
    for bad in (0, tokens.shape[1]):
        with pytest.raises(ValueError, match="prompt_len"):
            tkv.clustered_decode(tp, cfg, tokens, bad, device="cpu")
    with pytest.raises(ValueError, match="probes"):
        tkv.clustered_decode(tp, cfg, tokens, 48, probes=-1, device="cpu")
    # k_max 8 < probe_min_k: no head can route probed, the run is the same
    probed = tkv.clustered_decode(tp, cfg, tokens, 48, probes=2, device="cpu",
                                  gcfg=tkv.default_kv_config(8),
                                  refresh_every=6)
    assert probed["ppl"] == out["ppl"] and not probed["cuda_graph"]


@functools.lru_cache(maxsize=None)
def _hybrid(arch):
    """A float32 smoke model of ``arch`` (reference params, the port's
    carried) and 60 tokens."""
    cfg = dataclasses.replace(j_get_arch(arch, smoke=True), dtype="float32",
                              remat=False)
    jp = jax.jit(JM.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0))
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (1, 60), 0,
                                           cfg.vocab_size))
    return cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                      device="cpu"), tokens


def test_clustered_decode_on_a_hybrid_plan_matches_reference(monkeypatch):
    """Jamba's smoke period (Mamba layers, MoE every 2nd layer, attention
    at layer 4 only): one ``LayerKVCluster``, the Mamba and MoE layers'
    states riding in the same step. Both modes, the port fed the
    reference's draws: k* equal per head, refreshes equal, perplexities
    within 1e-4."""
    cfg, jp, tp, tokens = _hybrid("jamba_v0_1_52b")
    assert [i for i, (m, _) in enumerate(cfg.layer_plan())
            if m == "attn"] == [4]
    jheads = []
    init = jkv.OnlineKVCluster.__init__

    def recording_init(self, *a, **kw):
        init(self, *a, **kw)
        jheads.append(self)

    monkeypatch.setattr(jkv.OnlineKVCluster, "__init__", recording_init)
    gcfg, key = jkv.default_kv_config(16), jax.random.PRNGKey(2)

    def draws(layer, h, fits):
        head_key = jax.random.fold_in(key, layer * 1024 + h)
        return _injected(head_key, cfg.resolved_head_dim, gcfg)(fits)

    for mode in ("exact", "clustered"):
        want = jkv.clustered_decode(jp, cfg, jnp.asarray(tokens), 48,
                                    mode=mode, gcfg=gcfg, key=key,
                                    refresh_every=6)
        got = tkv.clustered_decode(tp, cfg, tokens, 48, mode=mode,
                                   gcfg=tkv.default_kv_config(16),
                                   draws=draws, device="cpu",
                                   refresh_every=6)
        assert got["steps"] == want["steps"] == 12
        assert got["ppl"] == pytest.approx(want["ppl"], rel=1e-4), mode
    assert got["k_stars"] == [cl.k_star for cl in jheads]
    assert len(got["k_stars"]) == cfg.num_kv_heads
    assert 0 < min(got["k_stars"]) and max(got["overflows"]) == 0
    assert got["refreshes"] == want["refreshes"] == cfg.num_kv_heads
    assert got["mean_k_star"] == want["mean_k_star"]


def test_clustered_decode_without_attention_layers():
    """RWKV6 has no attention layer: the exact mode runs (its state in
    the caches) and matches the reference; the clustered mode raises
    before the prefill (where the reference divides by zero heads)."""
    cfg, jp, tp, tokens = _hybrid("rwkv6_1_6b")
    want = jkv.clustered_decode(jp, cfg, jnp.asarray(tokens), 48,
                                mode="exact")
    got = tkv.clustered_decode(tp, cfg, tokens, 48, mode="exact",
                               device="cpu")
    assert got["steps"] == 12 and "k_stars" not in got
    assert got["ppl"] == pytest.approx(want["ppl"], rel=1e-4)
    with pytest.raises(ValueError, match="no attention layer"):
        tkv.clustered_decode(tp, cfg, tokens, 48, device="cpu")
