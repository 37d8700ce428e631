"""Online KV-cache clustering inside an autoregressive decode loop (the
counterpart of ``repro.serve.kv_cluster``).

Instead of attending to all n cached keys, the decode step attends to
the k* SILK-discovered key centroids of each (layer, kv head), each
weighted by its cluster mass:

- **Routing.** Every new key is assigned to a centroid by the model's
  ``predict`` (the L2 assignment kernel on the card).
- **Streaming center updates.** Each routed key drifts its centroid by an
  exponential moving average (``ema_update``; clusters that receive no
  row come back bit for bit); every ``refresh_every`` steps a full GEEK
  re-fit on the cache can grow or shrink k*.
- **Clustered attention.** ``softmax(q·c/√d + log mass) @ v_centroids``
  is per-key attention with every key/value moved to its centroid, so
  the error obeys the closed-form bound of ``error_bound``. On the card
  it is the hand-written ``flash_centroid_attention`` kernel.

The in-flight token's own K/V rides along unclustered (log-mass 0), so
the newest position is always exact; it joins a cluster via ``update``
right after the step.

Differences from the reference. Each fit draws from a ``torch.Generator``
seeded from ``(seed, layer, kv head, fit number)``; ``draws`` hands a fit
given arrays instead (the tests hand it the reference's). The center
index is not ported, so ``probes=`` raises (ROADMAP.md, Queue 1 item 9).
``use_flash`` is metadata: the device picks the route. Per-cluster sums
are sorted segment sums, never float atomics, so a run repeats its bits
on the card.
"""
from __future__ import annotations

import functools
import hashlib
import math
import time
from typing import NamedTuple

import torch

from repro_torch.core.api import GEEK, DenseData
from repro_torch.core.assign import segment_sum_rows
from repro_torch.core.geek import GeekConfig
from repro_torch.core.model import GeekModel, predict, update_centers
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models import model as MODEL
from repro_torch.models import transformer as T
from repro_torch.utils.device import full_precision_matmul, resolve_device

_NEG = -1e30


def default_kv_config(k_max: int = 64) -> GeekConfig:
    """A GeekConfig sized for per-head KV clustering (small d, small n):
    ``delta=1`` keeps SILK's seeding threshold permissive for a few
    thousand rows, and ``k_max`` caps the attention cost per step."""
    return GeekConfig(m=16, t=32, silk_l=5, delta=1, k_max=k_max,
                      pair_cap=8192)


class KVState(NamedTuple):
    """The attention-facing snapshot of one layer's clustered KV state.

    ``centers``/``v_cent`` are (Hkv, K, hd) key/value centroids and
    ``log_mass`` is (Hkv, K), ``-1e30`` marking dead centroid rows (the
    kernel's mask constant).
    """

    centers: torch.Tensor
    v_cent: torch.Tensor
    log_mass: torch.Tensor


def _segment_max(values: torch.Tensor, labels: torch.Tensor,
                 k: int) -> torch.Tensor:
    """(k,) float32 max of ``values`` per label, 0 where no row lands (an
    exact, order-free reduction)."""
    out = torch.zeros((k,), dtype=torch.float32, device=values.device)
    return out.scatter_reduce(0, labels, values, "amax", include_self=True)


def _counts(labels: torch.Tensor, k: int) -> torch.Tensor:
    """(k,) float32 rows per label. Sums of 1.0 are exact in any order, so
    ``index_add_`` is deterministic here, and unlike ``bincount`` it does
    not wait for the device."""
    out = torch.zeros((k,), dtype=torch.float32, device=labels.device)
    return out.index_add_(0, labels, torch.ones_like(labels,
                                                     dtype=torch.float32))


def _row_sums(x: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """(k, d) float32 sums of the rows of ``x`` by label. One row (a decode
    step's) lands alone, so ``index_add_`` adds it to 0 exactly; more rows
    take the sorted segment sums, which repeat their bits on the card."""
    if x.shape[0] <= 1:
        out = torch.zeros((k, x.shape[1]), dtype=torch.float32,
                          device=x.device)
        return out.index_add_(0, labels, x.to(torch.float32))
    return segment_sum_rows(x, labels, k)


def ema_update(centers, radius, mass, v_cent, v_radius, keys, values, labels,
               *, ema: float):
    """One streaming EMA step over a batch of routed keys/values.

    Per cluster l receiving m_l of the rows, the centroid moves
    ``c_l ← (1-ema)^{m_l} c_l + (1-(1-ema)^{m_l}) mean_l``. Clusters with
    m_l == 0 come back bit for bit. Radii stay upper bounds: both grow by
    the centroid drift and cover the new rows' distances.

    Parameters
    ----------
    centers, v_cent : (K, d) float32 key / value centroids.
    radius, v_radius, mass : (K,) float32.
    keys, values : (n, d) float32, the new rows, already routed.
    labels : (n,) int, the routing result.
    ema : float in (0, 1].

    Returns
    -------
    (centers, radius, mass, v_cent, v_radius), same shapes and dtypes.
    """
    k_max = centers.shape[0]
    lab = labels.to(torch.int64)
    m_new = _counts(lab, k_max)
    hit = m_new > 0
    safe = torch.clamp(m_new, min=1.0)[:, None]
    kmean = _row_sums(keys, lab, k_max) / safe
    vmean = _row_sums(values, lab, k_max) / safe
    decay = torch.pow(1.0 - ema, m_new)[:, None]
    c_new = torch.where(hit[:, None], centers * decay + (1.0 - decay) * kmean,
                        centers)
    v_new = torch.where(hit[:, None], v_cent * decay + (1.0 - decay) * vmean,
                        v_cent)
    drift_k = torch.linalg.norm(c_new - centers, dim=-1)
    drift_v = torch.linalg.norm(v_new - v_cent, dim=-1)
    seg_k = _segment_max(torch.linalg.norm(keys - c_new[lab], dim=-1), lab,
                         k_max)
    seg_v = _segment_max(torch.linalg.norm(values - v_new[lab], dim=-1), lab,
                         k_max)
    r_new = torch.where(hit, torch.maximum(radius + drift_k, seg_k), radius)
    vr_new = torch.where(hit, torch.maximum(v_radius + drift_v, seg_v),
                         v_radius)
    return c_new, r_new, mass + m_new, v_new, vr_new


def _value_stats(labels, values, valid):
    """Per-cluster (mass, value centroid, value radius) from fit labels."""
    k_max = valid.shape[0]
    lab = labels.to(torch.int64)
    mass = torch.bincount(lab, minlength=k_max).to(torch.float32)
    v_cent = segment_sum_rows(values, lab, k_max) / torch.clamp(
        mass, min=1.0)[:, None]
    v_radius = _segment_max(torch.linalg.norm(values - v_cent[lab], dim=-1),
                            lab, k_max)
    return mass, v_cent, v_radius


def fit_seed(*parts: int) -> int:
    """A 63-bit generator seed from a tuple of integers."""
    digest = hashlib.blake2b(repr(tuple(int(p) for p in parts)).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


class OnlineKVCluster:
    """Streaming GEEK clustering of one attention head's KV stream.

    Owns a ``GeekModel`` over the head's post-RoPE keys plus the value side
    (per-cluster mass, value centroid, value radius). ``start`` fits on the
    prefill, ``update`` routes and EMA-drifts per decode step, ``refresh``
    re-fits on the full cache. The raw cache stays with the caller.

    Parameters
    ----------
    gcfg : GeekConfig or None
        ``default_kv_config()`` when None.
    ema : float in (0, 1]
    probes
        Probed routing needs the center index: ``probes`` other than None
        raises ``NotImplementedError``.
    seed : int or tuple of ints
        Fit number f draws from a generator seeded with
        ``fit_seed(*seed, f)``.
    draws : callable or None
        ``draws(f)`` returns the bucketer for fit number f (1 for
        ``start``), which supplies that fit's arrays in place of the
        generator's (``core.api.LSHBucketer.split_key``).
    device : None, "cuda" or "cpu"
        ``None`` means ``cuda`` and raises without a card.
    """

    def __init__(self, gcfg: GeekConfig | None = None, *, ema: float = 0.1,
                 probes: int | None = None, seed=0, draws=None, device=None):
        self.gcfg = default_kv_config() if gcfg is None else gcfg
        if not 0.0 < ema <= 1.0:
            raise ValueError(f"ema must be in (0, 1], got {ema}")
        if probes is not None:
            raise NotImplementedError("probed routing (probes=) needs the "
                                      "center index (ROADMAP.md, Queue 1 "
                                      "item 9)")
        self.ema = float(ema)
        self.seed = tuple(seed) if isinstance(seed, (tuple, list)) else (seed,)
        self.draws = draws
        self.device = resolve_device(device)
        self._fits = 0
        self._k_star = 0
        self.model: GeekModel | None = None
        self.mass = self.v_cent = self.v_radius = None
        self.v_max = 0.0
        self.overflow = 0          # the last fit's SILK overflow
        self.pending = 0           # rows absorbed by EMA since the last fit
        self.refreshes = 0

    @property
    def k_star(self) -> int:
        """Discovered number of live clusters (0 before ``start``)."""
        return self._k_star if self.model is not None else 0

    def _fit(self, keys, values) -> None:
        """(Re)fit GEEK on the full key set; derive the value side."""
        self._fits += 1
        bucketer = None if self.draws is None else self.draws(self._fits)
        est = GEEK(self.gcfg, bucketer=bucketer, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(
            fit_seed(*self.seed, self._fits))
        keys = torch.as_tensor(keys, device=self.device).to(torch.float32)
        self.model = est.fit(DenseData(keys), gen)
        self._k_star = int(self.model.k_star)
        self.overflow = int(est.result_.overflow)
        values = torch.as_tensor(values, device=self.device).to(torch.float32)
        self.mass, self.v_cent, self.v_radius = _value_stats(
            est.result_.labels, values, self.model.center_valid)
        self.v_max = float(torch.linalg.norm(values, dim=-1).max())
        self.pending = 0

    def start(self, keys, values) -> None:
        """Initial fit on the prefill's (n, hd) keys/values."""
        self._fit(keys, values)

    def route(self, keys) -> torch.Tensor:
        """Assign (n, hd) keys to centroids with the model's exact
        ``predict``; returns (n,) int32 labels."""
        labels, _ = predict(self.model, torch.as_tensor(
            keys, device=self.device).to(torch.float32))
        return labels

    def update(self, keys, values) -> torch.Tensor:
        """Route a batch and EMA-drift the hit centroids; returns labels."""
        keys = torch.as_tensor(keys, device=self.device).to(torch.float32)
        values = torch.as_tensor(values, device=self.device).to(torch.float32)
        labels = self.route(keys)
        centers, radius, self.mass, self.v_cent, self.v_radius = ema_update(
            self.model.centers, self.model.radius, self.mass, self.v_cent,
            self.v_radius, keys, values, labels, ema=self.ema)
        self.model = update_centers(self.model, centers, radius=radius)
        if keys.shape[0]:
            self.v_max = max(self.v_max, float(
                torch.linalg.norm(values, dim=-1).max()))
        self.pending += int(keys.shape[0])
        return labels

    def refresh(self, keys, values) -> bool:
        """Re-fit on the full cached (n, hd) keys/values, re-discovering k*.
        With zero rows absorbed since the last fit this is a no-op: returns
        ``False`` and touches no state."""
        if self.pending == 0:
            return False
        self.refreshes += 1
        self._fit(keys, values)
        return True

    def head_state(self) -> KVState:
        """This head's (K, hd) attention-facing snapshot (no head axis)."""
        live = self.model.center_valid & (self.mass > 0)
        log_mass = torch.where(live, torch.log(torch.clamp(self.mass,
                                                           min=1e-9)), _NEG)
        return KVState(self.model.centers.to(torch.float32), self.v_cent,
                       log_mass.to(torch.float32))

    def error_bound(self, q_norm: float) -> float:
        """Closed-form bound on the clustered-attention output error.

        For any query with ``‖q‖ ≤ q_norm``, the L2 distance between exact
        per-key attention and this head's clustered attention is at most
        ``r_v + (e^{2ε} − 1)·v_max`` with ``ε = q_norm · r_k / √hd``
        (DESIGN.md §14).
        """
        live = self.model.center_valid & (self.mass > 0)
        r_k = float(torch.max(torch.where(live, self.model.radius, 0.0)))
        r_v = float(torch.max(torch.where(live, self.v_radius, 0.0)))
        hd = self.model.centers.shape[1]
        eps = q_norm * r_k / math.sqrt(hd)
        return r_v + (math.exp(2.0 * eps) - 1.0) * self.v_max


def stack_heads(heads) -> KVState:
    """Stack per-head ``head_state`` snapshots into one layer ``KVState``
    ((Hkv, K, hd) / (Hkv, K)); all heads share ``k_max``."""
    states = [h.head_state() for h in heads]
    return KVState(*(torch.stack(parts) for parts in zip(*states)))


def clustered_attention(q: torch.Tensor, state: KVState, *,
                        extra_k: torch.Tensor | None = None,
                        extra_v: torch.Tensor | None = None,
                        use_flash: bool = False) -> torch.Tensor:
    """Mass-weighted attention over centroids in the layer layout.

    Parameters
    ----------
    q : (B, S, Hq, hd) post-RoPE queries (``layers.attn_qkv``'s layout).
    state : KVState, (Hkv, K, hd) centroids shared across the batch.
    extra_k, extra_v : (B, S, Hkv, hd) or None
        Unclustered rows appended with log-mass 0 (the decode step's own
        K/V); they need S == 1.
    use_flash : bool
        Metadata, kept for the reference's signature: on the card this
        always runs ``flash_centroid_attention``'s kernel, on the CPU its
        plain version.

    Returns
    -------
    (B, S, Hq, hd) attention output in q's dtype.
    """
    B, S, hq, hd = q.shape
    hkv, K, _ = state.centers.shape
    c = state.centers.to(torch.float32).expand(B, hkv, K, hd)
    vc = state.v_cent.to(torch.float32).expand(B, hkv, K, hd)
    lm = state.log_mass.to(torch.float32).expand(B, hkv, K)
    if extra_k is not None:
        if S != 1:
            raise ValueError("extra_k/extra_v require S == 1 (decode step)")
        c = torch.cat([c, extra_k.to(torch.float32).transpose(1, 2)], dim=2)
        vc = torch.cat([vc, extra_v.to(torch.float32).transpose(1, 2)], dim=2)
        lm = torch.cat([lm, torch.zeros((B, hkv, S), dtype=torch.float32,
                                        device=q.device)], dim=2)
    o = kops.flash_centroid_attention(q.transpose(1, 2), c, vc, lm)
    return o.transpose(1, 2).to(q.dtype)


def make_clustered_step(cfg, *, use_flash: bool = False):
    """The clustered decode step for an ArchConfig.

    ``step(params, caches, cache_len, tokens, states)`` is
    ``models.model.decode_step`` with every attention layer's softmax over
    the cache replaced by ``clustered_attention`` over ``states[layer]``
    (a ``{global_layer: KVState}`` dict). The fresh K/V are still written
    into the raw cache (refreshes need them) and ride into the softmax as
    the exact extra rows.
    """
    def step(params, caches, cache_len, tokens, states):
        """One clustered decode step -> (logits (B, V), caches)."""
        def override(layer, p, h, *, positions, cache, cache_len):
            q, k, v = L.attn_qkv(p, h, cfg, positions=positions)
            L.cache_write(cache, k, v, cache_len)
            o = clustered_attention(q, states[layer], extra_k=k, extra_v=v,
                                    use_flash=use_flash)
            B, S = h.shape[:2]
            return o.reshape(B, S, -1).to(h.dtype) @ p["wo"], cache

        return MODEL.decode_step(params, cfg, caches, cache_len, tokens,
                                 override)

    return step


def _sync(device: torch.device) -> float:
    """Wait for the device; return the host clock."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def clustered_decode(params, cfg, tokens, prompt_len: int, *,
                     mode: str = "clustered", gcfg: GeekConfig | None = None,
                     ema: float = 0.1, refresh_every: int = 32,
                     probes: int | None = None, use_flash: bool = False,
                     seed: int = 0, draws=None, device=None) -> dict:
    """Teacher-forced decode with (or without) online KV clustering.

    Prefills ``tokens[:, :prompt_len]`` with exact attention (the flash
    kernel on the card), fits one ``OnlineKVCluster`` per (attention
    layer, kv head) on the prefill cache, then decodes the remaining
    positions one step at a time: clustered attention over the per-layer
    ``KVState`` snapshots, routing + EMA updates after every step, a
    re-fit on the full cache every ``refresh_every`` steps.
    ``mode="exact"`` runs the same harness through ``decode_step``.

    Parameters
    ----------
    params, cfg
        Model parameters on ``device`` and their ``ArchConfig`` (B == 1).
    tokens : (1, total) integer tokens; positions ``prompt_len..total-1``
        are scored.
    prompt_len : int, 0 < prompt_len < total.
    mode : {"clustered", "exact"}
    gcfg, ema, refresh_every, probes, use_flash
        Clustering knobs (``OnlineKVCluster``); ignored for "exact".
    seed : int
        Head h of layer l fits from ``fit_seed(seed, l, h, fit number)``.
    draws : callable or None
        ``draws(layer, h, fit_number)`` returns a bucketer holding that
        fit's arrays (``OnlineKVCluster``'s hook).
    device : None, "cuda" or "cpu"; ``None`` means ``cuda``.

    Returns
    -------
    dict
        ``ppl``/``nll`` over the decoded span, ``steps``, ``seconds``
        (synchronized host-clock times: ``prefill``, ``fits``, ``steps``
        one per decode step, ``refresh``), and for clustered mode
        ``mean_k_star``, ``compression`` (final cache length / mean k*),
        ``refreshes``, ``k_stars`` and ``overflows`` (per head, layer by
        layer, after the last fit).
    """
    dev = resolve_device(device)
    pdev = params["head"]["w"].device
    if pdev.type != dev.type or dev.index not in (None, pdev.index):
        raise ValueError(f"params live on {pdev}, decode on {dev}")
    dev = pdev
    tokens = torch.as_tensor(tokens, device=dev)
    if tokens.ndim != 2 or tokens.shape[0] != 1:
        raise ValueError("clustered_decode is single-sequence (B == 1)")
    if mode not in ("clustered", "exact"):
        raise ValueError(f"unknown mode {mode!r}")
    total = int(tokens.shape[1])
    if not 0 < prompt_len < total:
        raise ValueError(f"need 0 < prompt_len < {total}, got {prompt_len}")
    full_precision_matmul()
    attn_layers = [i for i, (mix, _) in enumerate(T.layer_plan(cfg))
                   if mix == "attn"]
    seconds = {"prefill": 0.0, "fits": 0.0, "steps": [], "refresh": 0.0}

    t0 = _sync(dev)
    caches = T.stack_cache_init(cfg, 1, total, dev)
    x, caches, _ = MODEL.forward(params, cfg, tokens[:, :prompt_len],
                                 caches=caches, cache_len=0)
    logits = (x[:, -1] @ params["head"]["w"]).to(torch.float32)
    t1 = _sync(dev)
    seconds["prefill"] = t1 - t0

    clusterers: dict[int, list[OnlineKVCluster]] = {}
    if mode == "clustered":
        for lyr in attn_layers:
            heads = []
            for h in range(cfg.num_kv_heads):
                cl = OnlineKVCluster(
                    gcfg, ema=ema, probes=probes, seed=(seed, lyr, h),
                    device=dev,
                    draws=None if draws is None else functools.partial(
                        draws, lyr, h))
                cl.start(caches[lyr]["k"][0, :prompt_len, h],
                         caches[lyr]["v"][0, :prompt_len, h])
                heads.append(cl)
            clusterers[lyr] = heads
        step_fn = make_clustered_step(cfg, use_flash=use_flash)
        t1 = _sync(dev)
        seconds["fits"] = t1 - t0 - seconds["prefill"]

    logp = []
    toks_host = tokens[0].tolist()
    for t in range(prompt_len, total):
        ts = _sync(dev)
        logp.append(float(torch.log_softmax(logits[0], dim=-1)[toks_host[t]]))
        if mode == "clustered":
            states = {lyr: stack_heads(clusterers[lyr])
                      for lyr in attn_layers}
            logits, caches = step_fn(params, caches, t, tokens[:, t:t + 1],
                                     states)
            for lyr in attn_layers:
                for h, cl in enumerate(clusterers[lyr]):
                    cl.update(caches[lyr]["k"][0, t, h][None],
                              caches[lyr]["v"][0, t, h][None])
            te = _sync(dev)
            seconds["steps"].append(te - ts)
            if (t - prompt_len + 1) % refresh_every == 0 and t + 1 < total:
                for lyr in attn_layers:
                    for h, cl in enumerate(clusterers[lyr]):
                        cl.refresh(caches[lyr]["k"][0, :t + 1, h],
                                   caches[lyr]["v"][0, :t + 1, h])
                seconds["refresh"] += _sync(dev) - te
        else:
            logits, caches = MODEL.decode_step(params, cfg, caches, t,
                                               tokens[:, t:t + 1])
            seconds["steps"].append(_sync(dev) - ts)

    nll = -sum(logp) / len(logp)
    out = {"mode": mode, "nll": nll, "ppl": math.exp(nll),
           "steps": len(logp), "seconds": seconds}
    if mode == "clustered":
        heads = [cl for lyr in attn_layers for cl in clusterers[lyr]]
        out["k_stars"] = [cl.k_star for cl in heads]
        out["overflows"] = [cl.overflow for cl in heads]
        out["mean_k_star"] = sum(out["k_stars"]) / len(heads)
        out["compression"] = total / max(out["mean_k_star"], 1.0)
        out["refreshes"] = sum(cl.refreshes for cl in heads)
    return out
