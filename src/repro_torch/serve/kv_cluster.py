"""Online KV-cache clustering inside an autoregressive decode loop (the
counterpart of ``repro.serve.kv_cluster``).

Instead of attending to all n cached keys, the decode step attends to
the k* SILK-discovered key centroids of each (layer, kv head), each
weighted by its cluster mass:

- **Routing.** Every new key is assigned to a centroid by the model's
  exact ``predict`` rule.
- **Streaming center updates.** Each routed key drifts its centroid by an
  exponential moving average (``ema_update``; clusters that receive no
  row come back bit for bit); every ``refresh_every`` steps a full GEEK
  re-fit on the cache can grow or shrink k*. On the card a decode step's
  route and update of all kv heads of a layer are one launch of the
  hand-written absorb kernel (``ops.l2_absorb_heads``), in place; a batch
  of several rows a head takes the head-batched L2 route kernel and one
  EMA (``absorb_plain``).
- **Clustered attention.** ``softmax(q·c/√d + log mass) @ v_centroids``
  is per-key attention with every key/value moved to its centroid, so
  the error obeys the closed-form bound of ``error_bound``. On the card
  the decode step runs the hand-written ``flash_centroid_decode`` kernel
  over the layer's state in place; ``clustered_attention`` (any (B, S))
  runs ``flash_centroid_attention``.

The in-flight token's own K/V rides along unclustered (log-mass 0), so
the newest position is always exact; it joins a cluster via ``update``
right after the step.

``LayerKVCluster`` holds one attention layer's heads as stacked device
tensors allocated once, fitted head by head and written in place, routed
and EMA-updated in one pass for all heads.
``OnlineKVCluster``, the per-head API, is a view of a one-head layer.
``clustered_decode``'s step reads nothing on the host, so on the card it
is captured once as a CUDA graph and replayed (the reference jits its
step); on the CPU the same step runs eagerly.

Differences from the reference. Each fit draws from a ``torch.Generator``
seeded from ``(seed, layer, kv head, fit number)``; ``draws`` hands a fit
given arrays instead (the tests hand it the reference's). ``probes=``
routes a head whose fit found k* >= ``probe_min_k`` through its model's
center index, as the reference's ``route`` does; such a step runs
eagerly. ``use_flash`` is metadata: the device picks the route.
Per-cluster sums are sorted segment sums, never float atomics, so a run
repeats its bits on the card.
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
#: the ``torch.profiler`` range of each decode step of ``clustered_decode``
STEP_SPAN = "clustered_decode.step"


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


def _row_sums(x: torch.Tensor, labels: torch.Tensor, k: int,
              rows: int | None = None) -> torch.Tensor:
    """(k, d) float32 sums of the rows of ``x`` by label. ``rows`` is the
    number of rows each head routed (``x.shape[0]``: one head). One row a
    head (a decode step's) lands alone in its cluster, so ``index_add_``
    adds it to 0 exactly; more rows take the sorted segment sums, which
    repeat their bits on the card and add a segment's rows in row order."""
    if (x.shape[0] if rows is None else rows) <= 1:
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
    return _ema(centers, radius, mass, v_cent, v_radius, keys, values,
                labels, ema=ema)


def _ema(centers, radius, mass, v_cent, v_radius, keys, values, labels, *,
         ema: float, rows: int | None = None):
    """``ema_update``. ``LayerKVCluster`` runs it once for all heads of a
    layer, flattened to (heads·K, …) with head h's labels offset by h·K:
    every per-cluster quantity is independent of the others, so each head
    gets its own result's bits. ``rows`` is the rows each head routed
    (``_row_sums``)."""
    k_max = centers.shape[0]
    lab = labels.to(torch.int64)
    m_new = _counts(lab, k_max)
    hit = m_new > 0
    safe = torch.clamp(m_new, min=1.0)[:, None]
    kmean = _row_sums(keys, lab, k_max, rows) / safe
    vmean = _row_sums(values, lab, k_max, rows) / safe
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


def absorb_plain(keys, values, centers, v_cent, radius, v_radius, mass,
                 center_valid, v_max, csq, *, ema: float):
    """Route (H, n, d) keys of H heads against each head's centers and
    EMA-drift the hit clusters, in place: the head-batched route
    (``ops.distance_argmin_l2_heads`` on ‖c‖² ``csq``), then one ``_ema``
    over the heads' states flattened to (H·K, …), head h's labels offset
    by h·K (every per-cluster quantity is independent of the others, so
    each head gets its own result's bits), then ``v_max``. The plain
    version of ``ops.l2_absorb_heads`` (its CPU path) and the card's path
    for n > 1. Returns (labels (H, n) int32, d² (H, n) float32)."""
    labels, d2 = kops.distance_argmin_l2_heads(keys.to(torch.float32),
                                               centers, csq, center_valid)
    _ema_heads(keys, values, labels, centers, v_cent, radius, v_radius, mass,
               v_max, ema=ema)
    return labels, d2


def _ema_heads(keys, values, labels, centers, v_cent, radius, v_radius, mass,
               v_max, *, ema: float) -> None:
    """EMA-drift the clusters that (H, n) ``labels`` hit, in place: one
    ``_ema`` over the heads' states flattened to (H·K, …), head h's labels
    offset by h·K, then ``v_max``."""
    H, n, d = keys.shape
    K = centers.shape[1]
    keys = keys.to(torch.float32)
    values = values.to(torch.float32)
    offsets = torch.arange(H, device=keys.device)[:, None] * K
    flat = (labels.to(torch.int64) + offsets).reshape(-1)
    new = _ema(centers.view(H * K, d), radius.view(-1), mass.view(-1),
               v_cent.view(H * K, d), v_radius.view(-1),
               keys.reshape(H * n, d), values.reshape(H * n, d), flat,
               ema=ema, rows=n)
    for dst, src in zip((centers, radius, mass, v_cent, v_radius), new):
        dst.copy_(src.view(dst.shape))
    if n:
        torch.maximum(v_max, torch.linalg.norm(values, dim=-1).amax(dim=1),
                      out=v_max)


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


def _check_knobs(ema: float, probes) -> None:
    if not 0.0 < ema <= 1.0:
        raise ValueError(f"ema must be in (0, 1], got {ema}")
    if probes is not None and int(probes) < 0:
        raise ValueError(f"probes must be >= 0, got {probes}")


class LayerKVCluster:
    """Online KV clustering of one attention layer: its kv heads' states
    stacked on the device, allocated once per run.

    The state, head h in row h: ``centers`` and ``v_cent`` (H, k_max, hd)
    float32; ``radius``, ``v_radius`` and ``mass`` (H, k_max) float32;
    ``center_valid`` (H, k_max) bool; ``v_max`` (H,) float32. Each head
    is its own GEEK fit, from its own generator seed, and a fit or refresh
    writes its result into the head's row in place, so the tensors'
    storage never moves and a CUDA graph that reads them stays valid.
    ``update`` routes every head's new keys and EMA-drifts the hit
    clusters of all heads in one pass (``absorb``): each head gets the
    bits of a one-head layer. No per-head ``GeekModel`` is
    kept up to date; ``head_model(h)`` rebuilds one from row h.

    Parameters
    ----------
    num_heads, head_dim : int
    gcfg : GeekConfig or None
        ``default_kv_config()`` when None.
    ema : float in (0, 1]
    probes, probe_min_k : int or None, int
        A head whose last fit found k* >= ``probe_min_k`` routes through
        its model's center index (``predict(probes=)``, the index as of
        that fit) when ``probes`` is not None; every other head routes
        exact. A layer with a probed head absorbs through the routes and
        one EMA (``_ema_heads``); otherwise a step's row takes the absorb
        kernel.
    seeds : sequence of int tuples, one per head, or None
        Head h's fit number f draws from a generator seeded with
        ``fit_seed(*seeds[h], f)``; None gives head h the tuple ``(h,)``.
    draws : callable or None
        ``draws(h, f)`` returns the bucketer of head h's fit number f (1
        for ``start``), which supplies that fit's arrays in place of the
        generator's (``core.api.LSHBucketer.split_key``).
    device : None, "cuda" or "cpu"
        ``None`` means ``cuda`` and raises without a card.
    """

    def __init__(self, num_heads: int, head_dim: int,
                 gcfg: GeekConfig | None = None, *, ema: float = 0.1,
                 probes: int | None = None, probe_min_k: int = 256,
                 seeds=None, draws=None, device=None):
        self.gcfg = default_kv_config() if gcfg is None else gcfg
        _check_knobs(ema, probes)
        self.ema = float(ema)
        self.probes = probes
        self.probe_min_k = int(probe_min_k)
        H, K = int(num_heads), self.gcfg.k_max
        self.seeds = [(h,) for h in range(H)] if seeds is None else [
            tuple(s) for s in seeds]
        if len(self.seeds) != H:
            raise ValueError(f"need {H} seeds, one a head, got "
                             f"{len(self.seeds)}")
        self.draws = draws
        self.device = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.centers = torch.zeros((H, K, head_dim), **f32)
        self.v_cent = torch.zeros((H, K, head_dim), **f32)
        self.radius = torch.zeros((H, K), **f32)
        self.v_radius = torch.zeros((H, K), **f32)
        self.mass = torch.zeros((H, K), **f32)
        self.center_valid = torch.zeros((H, K), dtype=torch.bool,
                                        device=self.device)
        self.v_max = torch.zeros((H,), **f32)
        # the EMA's factor for one routed row, as the plain EMA's torch.pow
        # computes it on this device: the absorb kernel's input
        self._decay = torch.pow(1.0 - self.ema, torch.ones((1,), **f32))
        self._models: list[GeekModel | None] = [None] * H
        self._fits = [0] * H
        self.k_stars = [0] * H      # per head, after its last fit
        self.overflows = [0] * H    # per head, its last fit's SILK overflow
        self.refreshes = [0] * H
        self.pending = 0            # rows each head absorbed since its fit

    @property
    def num_heads(self) -> int:
        return self.centers.shape[0]

    def _fit_row(self, h: int, keys, values) -> None:
        """Fit head h on its (n, hd) keys/values (a GEEK fit of the keys,
        then the value side); write row h in place."""
        self._fits[h] += 1
        bucketer = None if self.draws is None else self.draws(h,
                                                              self._fits[h])
        est = GEEK(self.gcfg, bucketer=bucketer, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(
            fit_seed(*self.seeds[h], self._fits[h]))
        keys = torch.as_tensor(keys, device=self.device).to(torch.float32)
        model = est.fit(DenseData(keys), gen)
        values = torch.as_tensor(values, device=self.device).to(torch.float32)
        mass, v_cent, v_radius = _value_stats(est.result_.labels, values,
                                              model.center_valid)
        for dst, src in ((self.centers, model.centers),
                         (self.radius, model.radius),
                         (self.center_valid, model.center_valid),
                         (self.mass, mass), (self.v_cent, v_cent),
                         (self.v_radius, v_radius),
                         (self.v_max, torch.linalg.norm(values, dim=-1).max())):
            dst[h].copy_(src)
        self._models[h] = model
        self.k_stars[h] = int(model.k_star)
        self.overflows[h] = int(est.result_.overflow)

    def start(self, keys, values) -> None:
        """Initial fits on the prefill's keys/values (n, H, hd), the cache
        layout: head h fits on ``keys[:, h]``."""
        for h in range(self.num_heads):
            self._fit_row(h, keys[:, h], values[:, h])
        self.pending = 0

    def probed_heads(self) -> list[int]:
        """The heads that route through their center index: ``probes``
        set and the head's last fit found k* >= ``probe_min_k``."""
        if self.probes is None:
            return []
        return [h for h in range(self.num_heads)
                if self._models[h] is not None
                and self._models[h].center_index is not None
                and self.k_stars[h] >= self.probe_min_k]

    def route(self, keys: torch.Tensor) -> torch.Tensor:
        """Assign (H, n, hd) keys, every head against its own centroids, in
        one launch (``ops.distance_argmin_l2_heads``; ‖c‖² computed once
        here): each head's labels those of the model's exact ``predict``.
        A probed head's (``probed_heads``) are then those of its model's
        ``predict(probes=)``. Returns (H, n) int32 labels."""
        keys = keys.to(torch.float32)
        csq = torch.sum(self.centers * self.centers, dim=-1)
        labels, _ = kops.distance_argmin_l2_heads(keys, self.centers, csq,
                                                  self.center_valid)
        for h in self.probed_heads():
            labels[h] = predict(self.head_model(h), keys[h],
                                probes=self.probes)[0]
        return labels

    def absorb(self, keys: torch.Tensor, values: torch.Tensor
               ) -> torch.Tensor:
        """Route (H, n, hd) keys/values and EMA-drift the hit clusters of
        all heads, in place. One row a head (a decode step's) goes through
        ``ops.l2_absorb_heads`` (on the card one launch of the absorb
        kernel; on the CPU ``absorb_plain``), more rows through
        ``absorb_plain``. ‖c‖² is computed here for the route. Device work
        only: nothing is read on the host, so a CUDA graph can hold it
        (``update`` also counts the rows). A layer with a probed head
        routes (``route``) and then drifts all heads in one EMA; that
        reads the device on the host. Returns (H, n) int32 labels."""
        if self.probed_heads():
            labels = self.route(keys)
            _ema_heads(keys, values, labels, self.centers, self.v_cent,
                       self.radius, self.v_radius, self.mass, self.v_max,
                       ema=self.ema)
            return labels
        state = (self.centers, self.v_cent, self.radius, self.v_radius,
                 self.mass, self.center_valid, self.v_max)
        csq = torch.sum(self.centers * self.centers, dim=-1)
        if keys.shape[1] == 1:
            labels, _ = kops.l2_absorb_heads(keys, values, *state, csq,
                                             ema=self.ema, decay=self._decay)
        else:
            labels, _ = absorb_plain(keys, values, *state, csq, ema=self.ema)
        return labels

    def update(self, keys: torch.Tensor, values: torch.Tensor
               ) -> torch.Tensor:
        """``absorb`` a batch, (H, n, hd), and count its rows; returns
        (H, n) int32 labels."""
        labels = self.absorb(keys, values)
        self.pending += int(keys.shape[1])
        return labels

    def refresh(self, keys, values) -> bool:
        """Re-fit every head on the full cached keys/values (n, H, hd),
        writing the rows in place. With zero rows absorbed since the last
        fit this is a no-op and returns ``False``."""
        if self.pending == 0:
            return False
        for h in range(self.num_heads):
            self.refreshes[h] += 1
            self._fit_row(h, keys[:, h], values[:, h])
        self.pending = 0
        return True

    def head_model(self, h: int) -> GeekModel | None:
        """Head h's ``GeekModel`` as its row stands (centers and radius
        copied from the stacked state); None before its first fit."""
        if self._models[h] is None:
            return None
        return update_centers(self._models[h], self.centers[h].clone(),
                              radius=self.radius[h].clone())

    def error_bound(self, h: int, q_norm: float) -> float:
        """Closed-form bound on head h's clustered-attention output error.

        For any query with ``‖q‖ ≤ q_norm``, the L2 distance between exact
        per-key attention and this head's clustered attention is at most
        ``r_v + (e^{2ε} − 1)·v_max`` with ``ε = q_norm · r_k / √hd``
        (DESIGN.md §14). One read of the device.
        """
        live = self.center_valid[h] & (self.mass[h] > 0)
        r_k, r_v, v_max = torch.stack([
            torch.max(torch.where(live, self.radius[h], 0.0)),
            torch.max(torch.where(live, self.v_radius[h], 0.0)),
            self.v_max[h]]).tolist()
        eps = q_norm * r_k / math.sqrt(self.centers.shape[2])
        return r_v + (math.exp(2.0 * eps) - 1.0) * v_max


class OnlineKVCluster:
    """Streaming GEEK clustering of one attention head's KV stream: a view
    of a one-head ``LayerKVCluster``, made at ``start``.

    Owns a ``GeekModel`` over the head's post-RoPE keys plus the value side
    (per-cluster mass, value centroid, value radius). ``start`` fits on the
    prefill, ``update`` routes and EMA-drifts per decode step, ``refresh``
    re-fits on the full cache. The raw cache stays with the caller.

    Parameters
    ----------
    gcfg : GeekConfig or None
        ``default_kv_config()`` when None.
    ema : float in (0, 1]
    probes, probe_min_k : int or None, int
        As in ``LayerKVCluster``: with ``probes`` set, the head routes
        through its center index once a fit finds k* >= ``probe_min_k``.
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
                 probes: int | None = None, probe_min_k: int = 256, seed=0,
                 draws=None, device=None):
        self.gcfg = default_kv_config() if gcfg is None else gcfg
        _check_knobs(ema, probes)
        self.ema = float(ema)
        self.probes = probes
        self.probe_min_k = int(probe_min_k)
        self.seed = tuple(seed) if isinstance(seed, (tuple, list)) else (seed,)
        self.draws = draws
        self.device = resolve_device(device)
        self.layer: LayerKVCluster | None = None

    def _row(self, name: str):
        return None if self.layer is None else getattr(self.layer, name)[0]

    @property
    def k_star(self) -> int:
        """Discovered number of live clusters (0 before ``start``)."""
        return 0 if self.layer is None else self.layer.k_stars[0]

    @property
    def model(self) -> GeekModel | None:
        """The head's ``GeekModel`` as it stands (None before ``start``)."""
        return None if self.layer is None else self.layer.head_model(0)

    mass = property(lambda self: self._row("mass"),
                    doc="(K,) float32 rows per cluster")
    v_cent = property(lambda self: self._row("v_cent"),
                      doc="(K, hd) float32 value centroids")
    v_radius = property(lambda self: self._row("v_radius"),
                        doc="(K,) float32 value radii")
    overflow = property(lambda self: 0 if self.layer is None
                        else self.layer.overflows[0],
                        doc="the last fit's SILK overflow")
    pending = property(lambda self: 0 if self.layer is None
                       else self.layer.pending,
                       doc="rows absorbed by EMA since the last fit")
    refreshes = property(lambda self: 0 if self.layer is None
                         else self.layer.refreshes[0],
                         doc="refits that ran")

    @property
    def v_max(self) -> float:
        """The largest value norm seen (the error bound's v_max), kept on
        the device and read from it only here (0.0 before ``start``)."""
        return 0.0 if self.layer is None else float(self.layer.v_max[0])

    def _rows(self, t) -> torch.Tensor:
        """(n, hd) rows as a float32 tensor on the device."""
        return torch.as_tensor(t, device=self.device).to(torch.float32)

    def start(self, keys, values) -> None:
        """Initial fit on the prefill's (n, hd) keys/values."""
        keys, values = self._rows(keys), self._rows(values)
        if self.layer is None:
            draws = None if self.draws is None else (
                lambda h, fit: self.draws(fit))
            self.layer = LayerKVCluster(
                1, keys.shape[-1], self.gcfg, ema=self.ema,
                probes=self.probes, probe_min_k=self.probe_min_k,
                seeds=[self.seed], draws=draws, device=self.device)
        self.layer.start(keys[:, None], values[:, None])

    def route(self, keys) -> torch.Tensor:
        """Assign (n, hd) keys to centroids with the model's ``predict``:
        probed once k* >= ``probe_min_k`` (with ``probes`` set), else
        exact; returns (n,) int32 labels."""
        return self.layer.route(self._rows(keys)[None])[0]

    def update(self, keys, values) -> torch.Tensor:
        """Route a batch and EMA-drift the hit centroids; returns labels."""
        return self.layer.update(self._rows(keys)[None],
                                 self._rows(values)[None])[0]

    def refresh(self, keys, values) -> bool:
        """Re-fit on the full cached (n, hd) keys/values, re-discovering k*.
        With zero rows absorbed since the last fit this is a no-op: returns
        ``False`` and touches no state."""
        return self.pending > 0 and self.layer.refresh(
            self._rows(keys)[:, None], self._rows(values)[:, None])

    def head_state(self) -> KVState:
        """This head's (K, hd) attention-facing snapshot (no head axis)."""
        live = self.layer.center_valid[0] & (self.mass > 0)
        log_mass = torch.where(live, torch.log(torch.clamp(self.mass,
                                                           min=1e-9)), _NEG)
        return KVState(self.layer.centers[0].clone(), self.v_cent.clone(),
                       log_mass.to(torch.float32))

    def error_bound(self, q_norm: float) -> float:
        """Closed-form bound on the clustered-attention output error
        (``LayerKVCluster.error_bound``)."""
        return self.layer.error_bound(0, q_norm)


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


def make_layer_step(cfg, layers: dict):
    """The clustered decode step over ``LayerKVCluster`` states.

    ``step(params, caches, position, tokens) -> logits (B, V)`` with
    ``position`` a one-element integer tensor on the device (the row the
    step writes and its position) and ``tokens`` (B, 1). Each attention
    layer writes its fresh K/V into the raw cache at ``position``
    (refreshes read them), attends through ``ops.flash_centroid_decode``
    over ``layers[layer]``'s state in place with the fresh rows as the
    exact extra rows, then absorbs them (route + EMA: on the card one
    launch of the absorb kernel a layer). Nothing is read on
    the host: a CUDA graph of the step replays at any position.
    """
    def step(params, caches, position, tokens):
        def override(layer, p, h, *, positions, cache, cache_len):
            q, k, v = L.attn_qkv(p, h, cfg, positions=positions)
            L.cache_write(cache, k, v, cache_len)
            lay = layers[layer]
            o = kops.flash_centroid_decode(q, lay.centers, lay.v_cent,
                                           lay.mass, lay.center_valid,
                                           extra_k=k, extra_v=v)
            lay.absorb(k[0].transpose(0, 1), v[0].transpose(0, 1))
            B, S = h.shape[:2]
            return o.reshape(B, S, -1).to(h.dtype) @ p["wo"], cache

        logits, _ = MODEL.decode_step(params, cfg, caches, position, tokens,
                                      override)
        return logits

    return step


class _Replay:
    """A CUDA graph of one call of ``fn``, captured after one eager call on
    a side stream (which does that call's work), then replayed. Capture
    works or raises. The launch counters (``ops.COUNTED``) count at each
    replay the kernels the capture recorded, and nothing for the capture
    itself, which launches none."""

    def __init__(self, fn):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.first = fn()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        before = [fn.launches for fn in kops.COUNTED]
        with torch.cuda.graph(self.graph):
            self.out = fn()
        self.launches = [(fn, fn.launches - n)
                         for fn, n in zip(kops.COUNTED, before)]
        for fn, n in self.launches:
            fn.launches -= n

    def __call__(self):
        self.graph.replay()
        for fn, n in self.launches:
            fn.launches += n
        return self.out


def _sync(device: torch.device) -> float:
    """Wait for the device; return the host clock."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def clustered_decode(params, cfg, tokens, prompt_len: int, *,
                     mode: str = "clustered", gcfg: GeekConfig | None = None,
                     ema: float = 0.1, refresh_every: int = 32,
                     probes: int | None = None, probe_min_k: int = 256,
                     use_flash: bool = False, seed: int = 0, draws=None,
                     device=None, cuda_graph: bool = True) -> dict:
    """Teacher-forced decode with (or without) online KV clustering.

    Prefills ``tokens[:, :prompt_len]`` with exact attention (the flash
    kernel on the card), fits one ``LayerKVCluster`` per attention layer
    (every kv head on its own) on the prefill cache, then decodes the
    remaining positions one step at a time (``make_layer_step``; the
    Mamba and RWKV layers of a hybrid plan advance their states in the
    same step, in place):
    clustered attention over each layer's state, then routing + EMA of
    the step's rows, a re-fit on the full cache every ``refresh_every``
    steps. On the card the clustered step is captured once as a CUDA graph
    (at the first step, which runs eagerly) and replayed; a refresh writes
    into the same storage, so the graph stays valid. ``mode="exact"`` runs
    the same harness through ``decode_step``. Log-probabilities stay on
    the device until the end.

    Parameters
    ----------
    params, cfg
        Model parameters on ``device`` and their ``ArchConfig`` (B == 1).
    tokens : (1, total) integer tokens; positions ``prompt_len..total-1``
        are scored.
    prompt_len : int, 0 < prompt_len < total.
    mode : {"clustered", "exact"}
        "clustered" needs an attention layer (RWKV6 has none: it raises
        ``ValueError`` before the prefill).
    gcfg, ema, refresh_every, probes, probe_min_k, use_flash
        Clustering knobs (``LayerKVCluster``); ignored for "exact". A
        probed route reads the device on the host, so the step runs
        eagerly whenever a head can reach ``probe_min_k`` (``probes`` set
        and ``gcfg.k_max >= probe_min_k``).
    seed : int
        Head h of layer l fits from ``fit_seed(seed, l, h, fit number)``.
    draws : callable or None
        ``draws(layer, h, fit_number)`` returns a bucketer holding that
        fit's arrays (``LayerKVCluster``'s hook, the layer
        bound).
    device : None, "cuda" or "cpu"; ``None`` means ``cuda``.
    cuda_graph : bool
        On the card, replay the clustered step as a CUDA graph (``False``
        runs it eagerly there too, for comparison). The CPU runs it
        eagerly either way.

    Returns
    -------
    dict
        ``ppl``/``nll`` over the decoded span, ``steps``, ``seconds``
        (synchronized host-clock times: ``prefill``, ``fits``, ``steps``
        one per decode step, the first with the graph's capture,
        ``refresh``), and for clustered mode ``mean_k_star``,
        ``compression`` (final cache length / mean k*), ``refreshes``,
        ``k_stars`` and ``overflows`` (per head, layer by layer, after the
        last fit) and ``cuda_graph`` (whether the step was replayed as a
        CUDA graph).
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
    k_max = (default_kv_config() if gcfg is None else gcfg).k_max
    graph = (dev.type == "cuda" and cuda_graph
             and (probes is None or k_max < probe_min_k))
    attn_layers = [i for i, (mix, _) in enumerate(cfg.layer_plan())
                   if mix == "attn"]
    if mode == "clustered" and not attn_layers:
        raise ValueError(f"{cfg.name} has no attention layer whose KV cache "
                         "could be clustered; use mode='exact'")
    seconds = {"prefill": 0.0, "fits": 0.0, "steps": [], "refresh": 0.0}

    t0 = _sync(dev)
    caches = T.stack_cache_init(cfg, 1, total, dev)
    x, caches, _ = MODEL.forward(params, cfg, tokens[:, :prompt_len],
                                 caches=caches, cache_len=0)
    logits = (x[:, -1] @ params["head"]["w"]).to(torch.float32)
    t1 = _sync(dev)
    seconds["prefill"] = t1 - t0

    layers: dict[int, LayerKVCluster] = {}
    if mode == "clustered":
        for lyr in attn_layers:
            layers[lyr] = LayerKVCluster(
                cfg.num_kv_heads, cfg.resolved_head_dim, gcfg, ema=ema,
                probes=probes, probe_min_k=probe_min_k, device=dev,
                seeds=[(seed, lyr, h) for h in range(cfg.num_kv_heads)],
                draws=None if draws is None else functools.partial(draws,
                                                                   lyr))
            layers[lyr].start(caches[lyr]["k"][0, :prompt_len],
                              caches[lyr]["v"][0, :prompt_len])
        step = make_layer_step(cfg, layers)
        t1 = _sync(dev)
        seconds["fits"] = t1 - t0 - seconds["prefill"]

    # the step's inputs live on the device, filled before each step
    position = torch.zeros((1,), dtype=torch.int64, device=dev)
    token = torch.zeros((1, 1), dtype=tokens.dtype, device=dev)
    replay = None
    logp = torch.empty((total - prompt_len,), dtype=torch.float32, device=dev)
    for i, t in enumerate(range(prompt_len, total)):
        ts = _sync(dev)
        with torch.profiler.record_function(STEP_SPAN):
            logp[i:i + 1] = torch.log_softmax(logits[0], dim=-1).index_select(
                0, tokens[0, t:t + 1])
            if mode == "exact":
                logits, caches = MODEL.decode_step(params, cfg, caches, t,
                                                   tokens[:, t:t + 1])
            else:
                position.fill_(t)
                token.copy_(tokens[:, t:t + 1])
                if replay is not None:
                    logits = replay()
                elif graph:
                    replay = _Replay(lambda: step(params, caches, position,
                                                  token))
                    logits = replay.first
                else:
                    logits = step(params, caches, position, token)
                for lay in layers.values():
                    lay.pending += 1
            te = _sync(dev)
        seconds["steps"].append(te - ts)
        if mode == "clustered" and (i + 1) % refresh_every == 0 \
                and t + 1 < total:
            for lyr, lay in layers.items():
                lay.refresh(caches[lyr]["k"][0, :t + 1],
                            caches[lyr]["v"][0, :t + 1])
            seconds["refresh"] += _sync(dev) - te

    nll = -sum(logp.tolist()) / len(logp)
    out = {"mode": mode, "nll": nll, "ppl": math.exp(nll),
           "steps": len(logp), "seconds": seconds}
    if mode == "clustered":
        lays = [layers[lyr] for lyr in attn_layers]
        out["k_stars"] = [k for lay in lays for k in lay.k_stars]
        out["overflows"] = [o for lay in lays for o in lay.overflows]
        out["mean_k_star"] = sum(out["k_stars"]) / len(out["k_stars"])
        out["compression"] = total / max(out["mean_k_star"], 1.0)
        out["refreshes"] = sum(sum(lay.refreshes) for lay in lays)
        out["cuda_graph"] = graph
    return out
