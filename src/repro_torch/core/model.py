"""GeekModel — the persistent fitted state of a GEEK run.

The counterpart of ``repro.core.model``: the central vectors (centroids
for l2, per-attribute mode codes for hamming) plus the metadata needed
to assign new points with the same one-pass kernels, and the numeric
discretizer of the hetero transform. ``predict(model, x)`` is the
serving-side twin of the fit-time assignment, one code path, so predict
on the fit rows reproduces the fit labels exactly. Centers are packed
once at build time (bit-packed words, or one-hot rows), so a predict
call packs only the incoming batch.

The model also carries a **center index** (``CenterIndex``): the k
centers hashed into the model's own LSH tables (QALSH projections for l2,
MinHash signatures over hashed (dim, code) items for code spaces), sorted
per table. ``predict(model, x, probes=p)`` scores only the centers whose
table positions fall in the query's window ± p bucket hops and falls back
to the exact scan for rows whose window holds no valid center. The index
is a function of the centers and a fixed seed (``_INDEX_SEED``), so
checkpoint restore rebuilds it, as the reference does. Its Hamming hashes
are the reference's bits (``utils.hashing.split`` and
``derive_hash_keys_from_key``); its l2 projection is the port's own
Gaussian draw (``torch.randn`` from a CPU generator seeded with
``_INDEX_SEED``), the same on every device. The probed scoring is plain
PyTorch (gathers, a batched product, a masked min), as the reference
keeps it outside Pallas; the exact scan and the fallback run the
assignment kernels on the card.

``use_pallas`` stays in the metadata so checkpoints round-trip with
``repro``; in the port the device, not ``use_pallas``, picks the route:
on the card the L2, the equality and the packed assignment always run
their kernels.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.pack import (field_mismatch_count, onehot_codes,
                                      pack_codes)
from repro_torch.utils.hashing import (UMAX32, derive_hash_keys_from_key,
                                       split)

#: canonical fields persisted by the checkpoint manager, in manifest order
ARRAY_FIELDS = ("centers", "center_valid", "k_star", "radius")


# ---------------------------------------------------------------------------
# Numeric discretization with persisted quantile boundaries
# ---------------------------------------------------------------------------

def quantile_boundaries(v_sorted: torch.Tensor, t_cat: int) -> torch.Tensor:
    """(d, t_cat - 1) bin boundaries from per-attribute ascending-sorted
    (n, d) values.

    Boundary b (1-based) is the value at rank ``ceil(b*n/t_cat)``; ranks
    beyond n-1 (empty tail bins when n < t_cat) become +inf.
    """
    n = v_sorted.shape[0]
    r = (np.arange(1, t_cat) * n + t_cat - 1) // t_cat
    picked = v_sorted[torch.as_tensor(np.minimum(r, n - 1),
                                      device=v_sorted.device)]
    tail = torch.as_tensor((r >= n)[:, None], device=v_sorted.device)
    return torch.where(tail, torch.inf, picked).T.contiguous()


@dataclasses.dataclass(frozen=True)
class NumericDiscretizer:
    """Per-attribute quantile bin boundaries, fitted once and persisted.

    Codes are ``searchsorted(boundaries[j], x[:, j], right=True)`` per
    attribute, so coding a point depends only on the fitted boundaries,
    never on the batch it arrives in.
    """
    boundaries: torch.Tensor    # (d_num, t_cat - 1) float32, rows ascending

    @property
    def d_num(self) -> int:
        """Number of numeric attributes the boundaries were fitted on."""
        return self.boundaries.shape[0]

    @property
    def t_cat(self) -> int:
        """Number of discretization bins (boundaries + 1)."""
        return self.boundaries.shape[1] + 1

    @classmethod
    def fit(cls, x_num: torch.Tensor, t_cat: int) -> "NumericDiscretizer":
        """Fit per-attribute quantile boundaries from an (n, d_num) batch."""
        return cls(quantile_boundaries(torch.sort(x_num, dim=0).values,
                                       t_cat))

    def __call__(self, x_num: torch.Tensor) -> torch.Tensor:
        """Code a batch: (n, d_num) floats -> (n, d_num) int32 bins."""
        if x_num.ndim != 2 or x_num.shape[1] != self.d_num:
            raise ValueError(f"expected (n, {self.d_num}) numeric input, "
                             f"got {tuple(x_num.shape)}")
        codes = torch.searchsorted(self.boundaries,
                                   x_num.to(self.boundaries.dtype).T
                                   .contiguous(), right=True)
        return codes.T.to(torch.int32)


# ---------------------------------------------------------------------------
# Center index: the model's own LSH tables over its k centers
# ---------------------------------------------------------------------------

#: the index's fixed seed: the index is a function of (centers,
#: center_valid, metric, tables, bucket), so restore rebuilds it
_INDEX_SEED = 0x6EEC


@dataclasses.dataclass(frozen=True)
class CenterIndex:
    """Per-table sorted LSH keys over the model's centers.

    Row t of ``sorted_keys`` holds table t's hash of every center in
    ascending order (a stable sort, so equal keys keep center order),
    ``sorted_ids`` the matching center rows. A query is hashed with the
    same ``hashers`` and probed by position: ``searchsorted`` finds its
    rank in each table and a window of ``bucket``-sized hops around it
    gives the candidates. Invalid centers are keyed +inf (l2) or
    ``UMAX32`` (hamming) so they sort to the tail; the window is clipped
    at ``n_valid``.
    """

    hashers: tuple            # l2: (proj (d, T),); hamming: (item_keys
                              # (1, 2), sig_keys (T, 2, 2)), both carried
    sorted_keys: torch.Tensor  # (T, k_max) float32 (l2) / int64 carrier
    sorted_ids: torch.Tensor   # (T, k_max) int32 center rows, key-ascending
    n_valid: torch.Tensor      # () int32, live centers
    metric: str = "l2"
    bucket: int = 32          # multi-probe step, in sorted positions

    @property
    def num_tables(self) -> int:
        """Number of hash tables (rows of ``sorted_keys``)."""
        return self.sorted_keys.shape[0]

    def query_keys(self, x: torch.Tensor) -> torch.Tensor:
        """Hash a query batch with the index's own functions: (T, n)."""
        from repro_torch.core import lsh
        if self.metric == "l2":
            (proj,) = self.hashers
            return lsh.qalsh_hash(x.to(torch.float32), proj).T
        item_keys, sig_keys = self.hashers
        return lsh.minhash_signatures(
            lsh.code_items(x.to(torch.int32), item_keys), None, sig_keys)


def _index_hashers(metric: str, d: int, tables: int, device) -> tuple:
    """The index's hash functions from ``_INDEX_SEED``.

    hamming: the reference's bits — ``item, sig = split(PRNGKey(seed))``,
    the item pair ``derive_hash_keys(item, (1,))`` (what ``code_items``
    derives) and the signature keys ``derive_hash_keys(sig, (tables,
    2))``. l2: a (d, tables) N(0, 1) projection drawn on the CPU from a
    generator seeded with ``_INDEX_SEED`` and moved to ``device``, so the
    index is the same function of the centers on every device.
    """
    if metric == "l2":
        gen = torch.Generator().manual_seed(_INDEX_SEED)
        return (torch.randn((d, tables), generator=gen).to(device),)
    item_key, sig_key = split(torch.tensor([0, _INDEX_SEED]))
    return (derive_hash_keys_from_key(item_key, (1,)).to(device),
            derive_hash_keys_from_key(sig_key, (tables, 2)).to(device))


def build_center_index(centers: torch.Tensor, center_valid: torch.Tensor, *,
                       metric: str, tables: int = 8, bucket: int = 32,
                       hashers: tuple | None = None) -> CenterIndex:
    """Hash the centers into per-table sorted LSH keys.

    QALSH projections for l2, MinHash signatures over hashed (dim, code)
    items for code spaces (``_index_hashers``). ``hashers`` replaces the
    drawn functions (the parity tests pass the reference's l2
    projection; ``checkpoint.manager.model_from_numpy`` passes what it
    is given). Returns the index on the centers' device.
    """
    from repro_torch.core import lsh
    if hashers is None:
        hashers = _index_hashers(metric, int(centers.shape[1]), tables,
                                centers.device)
    if metric == "l2":
        proj = hashers[0].to(device=centers.device, dtype=torch.float32)
        hashers = (proj,)
        hashed = lsh.qalsh_hash(centers.to(torch.float32), proj)   # (k, T)
        keys = torch.where(center_valid[:, None], hashed, torch.inf).T
    else:
        item_keys, sig_keys = (h.to(device=centers.device,
                                    dtype=torch.int64) for h in hashers)
        hashers = (item_keys, sig_keys)
        sigs = lsh.minhash_signatures(
            lsh.code_items(centers.to(torch.int32), item_keys), None,
            sig_keys)                                              # (T, k)
        keys = torch.where(center_valid[None, :], sigs, UMAX32)
    order = torch.argsort(keys.contiguous(), dim=1, stable=True)
    return CenterIndex(hashers, torch.gather(keys, 1, order),
                       order.to(torch.int32),
                       center_valid.sum().to(torch.int32), metric,
                       int(bucket))


def _probe_width(index: CenterIndex, probes: int) -> int:
    """Candidate-window width per table for a probe count.

    l2 probes by rank: the query's position ± probes bucket hops (an odd
    multiple of the bucket, centered). Hamming probes by signature run:
    the exact-match run plus probes hops each side, so at ``probes=0`` a
    signature no center has gives an empty window (the fallback).
    """
    k = index.sorted_keys.shape[1]
    bw = max(int(index.bucket), 1)
    if index.metric == "l2":
        return min((2 * probes + 1) * bw, k)
    return min((2 * probes + 2) * bw, k)


def probe_candidates(index: CenterIndex, x: torch.Tensor, probes: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidate center rows for each query by positional multi-probe.

    ``x`` (n, d) queries in the model's assignment space. Returns (n,
    T·width) int64 candidate rows and a bool mask of the entries that are
    real probe hits (the rest are positional padding).
    """
    T, k = index.sorted_keys.shape
    width = _probe_width(index, probes)
    bw = max(int(index.bucket), 1)
    qk = index.query_keys(x).contiguous()                        # (T, n)
    if index.metric == "l2":
        lo = torch.searchsorted(index.sorted_keys, qk) - width // 2
        hi = lo + width
    else:
        lo = torch.searchsorted(index.sorted_keys, qk) - probes * bw
        hi = torch.searchsorted(index.sorted_keys, qk,
                                right=True) + probes * bw
    start = torch.clamp(lo, min=0)
    grid = start[:, :, None] + torch.arange(width, device=x.device)
    mask = grid < torch.clamp(hi, max=index.n_valid)[:, :, None]  # (T, n, w)
    ids = torch.gather(index.sorted_ids.to(torch.int64), 1,
                       torch.clamp(grid, 0, k - 1).reshape(T, -1))
    n = x.shape[0]
    cand = ids.view(T, n, width).permute(1, 0, 2).reshape(n, T * width)
    return cand, mask.permute(1, 0, 2).reshape(n, T * width)


@dataclasses.dataclass(frozen=True)
class GeekModel:
    """The persistent fitted state of a GEEK run (module docstring)."""

    # -- canonical fitted state (serialized) --------------------------------
    centers: torch.Tensor        # (k_max, d) float32 centroids / int32 modes
    center_valid: torch.Tensor   # (k_max,) bool
    k_star: torch.Tensor         # () int32 — discovered #clusters
    radius: torch.Tensor         # (k_max,) per-cluster max distance at fit
    # -- derived caches (rebuilt from centers, never serialized) -------------
    packed_centers: torch.Tensor | None = None  # (k_max, w) int32 words
    onehot_centers: torch.Tensor | None = None  # (k_max, d * 2**bits) bf16
    center_index: CenterIndex | None = None     # None: index_tables == 0
    transform: object = None     # the fit-time transform (None: pre-coded)
    # -- static dispatch metadata (checkpoint manifest) ----------------------
    metric: str = "l2"
    impl: str = ""
    code_bits: int = 0
    d: int = 0
    assign_block: int = 4096
    use_pallas: bool = False
    bucketer_id: str = ""
    seeder_id: str = ""
    index_tables: int = 8
    index_bucket: int = 32

    @property
    def k_max(self) -> int:
        """Static cluster budget (rows of ``centers``)."""
        return self.centers.shape[0]

    @property
    def device(self) -> torch.device:
        """The device the model's tensors (and its predict) live on."""
        return self.centers.device

    def encode(self, *parts) -> torch.Tensor:
        """Code raw inputs into the model's assignment space: ``(x,)``
        dense, ``(x_num, x_cat)`` hetero, ``(sets, mask)`` sparse."""
        if self.transform is None:
            if len(parts) == 1:
                return parts[0]   # a model without transform takes codes
            raise ValueError("model has no fit-time transform; pass "
                             "pre-transformed codes to predict() instead")
        return self.transform(*parts)

    def static_meta(self) -> dict:
        """JSON-serializable dispatch metadata (checkpoint manifest extra)."""
        return {"metric": self.metric, "impl": self.impl,
                "code_bits": self.code_bits, "d": self.d,
                "assign_block": self.assign_block,
                "use_pallas": self.use_pallas,
                "bucketer_id": self.bucketer_id,
                "seeder_id": self.seeder_id,
                "index_tables": self.index_tables,
                "index_bucket": self.index_bucket}


def build_model(centers: torch.Tensor, center_valid: torch.Tensor,
                k_star: torch.Tensor, radius: torch.Tensor, *,
                metric: str, impl: str = "", code_bits: int = 0,
                assign_block: int = 4096, use_pallas: bool = False,
                transform=None, bucketer_id: str = "", seeder_id: str = "",
                index_tables: int = 8, index_bucket: int = 32) -> GeekModel:
    """Construct a GeekModel, packing centers once for the chosen impl:
    the one constructor of every fit path and of checkpoint restore.

    ``centers`` are centroids (l2) or mode codes (hamming); ``impl`` is
    the resolved Hamming impl ("equality" | "packed" | "onehot"),
    ignored for l2. A hamming model without ``transform`` predicts on
    pre-coded input. ``index_tables > 0`` builds the center index
    (``build_center_index``); 0 leaves it out, and ``predict(probes=)``
    then raises.
    """
    if metric not in ("l2", "hamming"):
        raise ValueError(f"unknown metric {metric!r}")
    if metric == "hamming" and impl not in ("equality", "packed", "onehot"):
        raise ValueError(f"unresolved hamming impl {impl!r}")
    packed = onehot = None
    if metric == "hamming":
        if impl == "packed":
            packed = pack_codes(centers, code_bits)
        elif impl == "onehot":
            onehot = onehot_codes(centers, 1 << code_bits)
    if transform is None and metric == "l2":
        from repro_torch.core.transform import IdentityTransform
        transform = IdentityTransform()
    index = None
    if index_tables > 0:
        index = build_center_index(centers, center_valid, metric=metric,
                                   tables=index_tables, bucket=index_bucket)
    return GeekModel(centers, center_valid, k_star, radius, packed, onehot,
                     index, transform, metric,
                     impl if metric == "hamming" else "",
                     int(code_bits), int(centers.shape[1]),
                     int(assign_block), bool(use_pallas), bucketer_id,
                     seeder_id, int(index_tables), int(index_bucket))


def predict_l2(model: GeekModel, x: torch.Tensor):
    """L2 assignment, shared by ``predict`` and the fit-time pass.

    Returns (n,) int32 labels and (n,) float32 Euclidean distances.
    """
    labels, d2 = kops.distance_argmin_l2(x, model.centers, model.center_valid,
                                         block=model.assign_block)
    return labels, torch.sqrt(d2)


def predict_hamming(model: GeekModel, codes: torch.Tensor):
    """Hamming assignment (equality / packed / one-hot), shared by
    ``predict`` and the fit-time pass.

    ``codes`` (n, d) int32 in the model's code space. Returns (n,) int32
    labels and (n,) float32 mismatch fractions (counts / d, ≈ 1 −
    Jaccard), as the reference normalizes them.
    """
    from repro_torch.core import assign as assign_mod
    bits, d = model.code_bits, model.d
    if model.impl == "packed":
        labels, dists = kops.distance_argmin_hamming_packed(
            pack_codes(codes, bits), model.packed_centers,
            model.center_valid, bits=bits, d=d, block=model.assign_block)
    elif model.impl == "onehot":
        labels, dists = assign_mod.assign_hamming_onehot(
            codes, model.centers, model.center_valid, card=1 << bits,
            block=model.assign_block, centers_onehot=model.onehot_centers)
    else:
        labels, dists = kops.distance_argmin_hamming(
            codes, model.centers, model.center_valid,
            block=model.assign_block)
    return labels, dists / d


def _exact(model: GeekModel, x: torch.Tensor):
    """The exact O(k) scan of (n, d) rows already on the model's device."""
    if model.metric == "l2":
        return predict_l2(model, x)
    return predict_hamming(model, x)


def _as_queries(model: GeekModel, x) -> torch.Tensor:
    """``x`` on the model's device, float32 (l2) or int32 (hamming),
    shape-checked."""
    dtype = torch.float32 if model.metric == "l2" else torch.int32
    x = torch.as_tensor(x, device=model.device).to(dtype)
    if x.ndim != 2 or x.shape[1] != model.d:
        raise ValueError(f"expected (n, {model.d}) input, got {tuple(x.shape)}")
    return x


def predict_probed(model: GeekModel, x, probes: int):
    """Index-probed assignment: scores only the ``T·width`` candidates of
    each row's probe windows instead of all k centers.

    Rows whose windows hold no valid center come back ``label 0, dist
    inf, empty True``; ``patch_probed_fallback`` (which ``predict(probes=)``
    calls) replaces them with the exact scan. Wherever a row's windows hold
    its exact argmin, the probed label is the exact label (ties to the
    smallest center row on both paths). Rows go in blocks of at most
    ``assign_block`` and about 2**25 gathered elements; a batch of more
    than one block is zero-padded to whole blocks, as the reference
    pads it. Returns (labels int32, dists float32, empty bool), dists
    normalized as ``predict``'s.
    """
    x = _as_queries(model, x)
    index = model.center_index
    if index is None:
        raise ValueError("model has no center index (built with "
                         "index_tables=0); predict with probes=None")
    probes = int(probes)
    if probes < 0:
        raise ValueError(f"probes must be >= 0, got {probes}")
    n_cand = index.num_tables * _probe_width(index, probes)
    block = max(1, min(model.assign_block,
                       (1 << 25) // max(n_cand * model.d, 1)))
    # center norms once a call, gathered per candidate
    cnorms = (torch.sum(model.centers * model.centers, dim=-1)
              if model.metric == "l2" else None)

    def block_fn(xb):
        cand, mask = probe_candidates(index, xb, probes)
        mask = mask & model.center_valid[cand]
        if model.metric == "l2":
            cc = model.centers[cand]                          # (B, C, d)
            dist = (torch.sum(xb * xb, dim=-1)[:, None]
                    - 2.0 * torch.bmm(cc, xb[:, :, None])[:, :, 0]
                    + cnorms[cand])
        elif model.impl == "packed":
            xp = pack_codes(xb, model.code_bits)
            cp = model.packed_centers[cand]
            dist = field_mismatch_count(cp ^ xp[:, None, :], model.code_bits
                                        ).sum(dim=-1).to(torch.float32)
        else:
            cc = model.centers[cand].to(torch.int32)
            dist = (cc != xb[:, None, :]).sum(dim=-1).to(torch.float32)
        dist = torch.where(mask, dist, torch.inf)
        mind = torch.min(dist, dim=1).values
        empty = ~torch.any(mask, dim=1)
        tie = torch.where(mask & (dist == mind[:, None]), cand, model.k_max)
        labels = torch.where(empty, 0, torch.min(tie, dim=1).values)
        out = (torch.sqrt(torch.clamp(mind, min=0.0))
               if model.metric == "l2" else mind / model.d)
        return (labels.to(torch.int32),
                torch.where(empty, torch.inf, out).to(torch.float32), empty)

    n = x.shape[0]
    if n <= block:
        return block_fn(x)
    xp_ = torch.nn.functional.pad(x, (0, 0, 0, (-n) % block))
    outs = [block_fn(xb) for xb in xp_.split(block)]
    return tuple(torch.cat(parts)[:n] for parts in zip(*outs))


def patch_probed_fallback(labels, dists, empty, exact_fn):
    """Replace the empty-probe rows of ``predict_probed``'s outputs with
    the exact scan; every serving surface shares this repair step.

    ``exact_fn(row_idx) -> (labels, dists)`` runs the exact path on the
    given rows of the original batch. The rows are cyclically padded to a
    power of two of at least 16, as the reference pads them: the CPU's
    matrix product rounds a batch of fewer than four rows differently, and
    the padded batch keeps the exact path's bits. One read of ``empty``
    on the host. Returns new (labels, dists).
    """
    idx = torch.nonzero(empty).flatten()
    if idx.numel() == 0:
        return labels, dists
    m = 1 << max(4, (idx.numel() - 1).bit_length())
    lab, dst = exact_fn(idx.repeat(-(-m // idx.numel()))[:m])
    labels, dists = labels.clone(), dists.clone()
    labels[idx] = lab[:idx.numel()]
    dists[idx] = dst[:idx.numel()]
    return labels, dists


def predict(model: GeekModel, x, probes: int | None = None):
    """One-pass assignment of new points against a fitted model.

    ``x`` is (n, d): dense rows (moved to the model's device as float32)
    or, for a hamming model, codes in its code space (``model.encode``;
    moved as int32). The model's device (the fit's, or restore's
    ``device``) is where predict runs. ``probes=None`` is the exact O(k)
    scan; ``probes=p >= 0`` probes the center index (``predict_probed``)
    and patches empty-probe rows with the exact scan
    (``patch_probed_fallback``). Returns (labels, dists); on the fit rows
    the exact labels equal the fit labels.
    """
    x = _as_queries(model, x)
    if probes is None:
        return _exact(model, x)
    labels, dists, empty = predict_probed(model, x, probes)
    return patch_probed_fallback(labels, dists, empty,
                                 lambda idx: _exact(model, x[idx]))


def update_centers(model: GeekModel, centers: torch.Tensor, *,
                   center_valid: torch.Tensor | None = None,
                   k_star: torch.Tensor | None = None,
                   radius: torch.Tensor | None = None,
                   rebuild_index: bool = False) -> GeekModel:
    """Swap a fitted model's centers (the online-drift hook).

    Streaming consumers (``repro_torch.serve.kv_cluster``) move centers a
    little every step (EMA drift) and a lot every refresh (re-fit). The
    derived packed/one-hot caches are pure functions of the centers, so
    they are re-derived here. ``center_valid``, ``k_star`` and ``radius``
    replace the fitted fields when given. The center index is rebuilt
    only with ``rebuild_index`` (a sort per table); a stale index only
    lowers probed recall, since candidates are scored exactly. Returns a
    new model; the input is untouched.
    """
    if tuple(centers.shape) != tuple(model.centers.shape):
        raise ValueError(f"centers shape {tuple(centers.shape)} != fitted "
                         f"{tuple(model.centers.shape)}")
    valid = model.center_valid if center_valid is None else center_valid
    packed, onehot = model.packed_centers, model.onehot_centers
    if model.metric == "hamming":
        if model.impl == "packed":
            packed = pack_codes(centers, model.code_bits)
        elif model.impl == "onehot":
            onehot = onehot_codes(centers, 1 << model.code_bits)
    index = model.center_index
    if rebuild_index and model.index_tables > 0:
        index = build_center_index(centers, valid, metric=model.metric,
                                   tables=model.index_tables,
                                   bucket=model.index_bucket,
                                   hashers=None if index is None
                                   else index.hashers)
    return dataclasses.replace(
        model, centers=centers, center_valid=valid,
        k_star=model.k_star if k_star is None else k_star,
        radius=model.radius if radius is None else radius,
        packed_centers=packed, onehot_centers=onehot, center_index=index)
