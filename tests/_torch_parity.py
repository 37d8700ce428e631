"""Shared helpers for the PyTorch port's parity tests (``test_torch_*``).

Inputs are made with numpy from a seed and handed to both packages as
arrays; uint32 values cross as numpy uint32 and enter the port in its
int64 carrier.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import pytest
import torch

import repro_torch as rt


#: validity layouts of k centers that the L2 kernel's skipping of wholly
#: dead 64-center tiles must keep: name -> (k, valid of arange(k))
DEAD_TILE_LAYOUTS = {
    "live prefix": (1024, lambda i: i < 158),
    "leading dead tiles": (300, lambda i: i >= 150),
    "dead tile between live ones": (200, lambda i: (i < 40) | (i >= 140)),
    "all dead": (130, lambda i: np.zeros(i.shape, bool)),
    "k not a multiple of the tile": (70, lambda i: i % 7 != 3),
}


def dead_tile_layout(name: str, n: int, d: int, seed: int = 0):
    """(x (n, d), centers (k, d) float32, valid (k,) bool) of one layout."""
    k, live = DEAD_TILE_LAYOUTS[name]
    rng = np.random.default_rng([seed, n, d, k])
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    return x, c, live(np.arange(k))


@pytest.fixture
def cuda_device():
    """The card, or a skip with the reason (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only "
                    "on the card")
    return torch.device("cuda")


def u32(t) -> np.ndarray:
    """A port carrier tensor (or any integer array) as numpy uint32."""
    if isinstance(t, torch.Tensor):
        t = t.cpu().numpy()
    return (np.asarray(t).astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)


def carrier(a) -> torch.Tensor:
    """numpy/JAX uint32 -> the port's int64 carrier."""
    return torch.from_numpy(np.asarray(a).astype(np.uint32).astype(np.int64))


def near_ties(x, centers, valid, lab_a, lab_b, rtol: float = 1e-5):
    """Split rows whose labels differ into (near_ties, disagreements).

    A row is a near-tie when, in float64, its distances to the two
    labelled centers differ by at most ``rtol·(‖x‖² + max‖c‖²)``: about
    170 float32 ulps of the expansion ‖x‖² − 2x·c + ‖c‖², well above the
    rounding of either side, far below any real gap.
    """
    x64 = np.asarray(x, np.float64)
    c64 = np.asarray(centers, np.float64)
    lab_a, lab_b = np.asarray(lab_a), np.asarray(lab_b)
    rows = np.flatnonzero(lab_a != lab_b)
    if rows.size == 0:
        return rows, rows
    da = ((x64[rows] - c64[lab_a[rows]]) ** 2).sum(1)
    db = ((x64[rows] - c64[lab_b[rows]]) ** 2).sum(1)
    scale = (x64[rows] ** 2).sum(1) + (c64[np.asarray(valid)] ** 2).sum(1).max()
    near = np.abs(da - db) <= rtol * scale
    return rows[near], rows[~near]


def assert_labels_match(x, centers, valid, lab_ref, lab_port, what: str,
                        max_ties: int | None = None):
    """Labels equal except at near-ties, which are counted and named."""
    ties, bad = near_ties(x, centers, valid, lab_ref, lab_port)
    if ties.size:
        print(f"{what}: {ties.size} near-tie rows {ties.tolist()[:20]}")
    assert bad.size == 0, f"{what}: labels disagree beyond near-ties at " \
                          f"rows {bad.tolist()[:20]}"
    if max_ties is not None:
        assert ties.size <= max_ties, f"{what}: {ties.size} near-ties"
    return ties.size


@dataclasses.dataclass(frozen=True)
class InjectedBucketer(rt.LSHBucketer):
    """The stock bucketer with the fit's draws replaced by given arrays
    (the reference's JAX-drawn ones): ``a`` for dense, ``item_keys`` and
    ``sig_keys`` for hetero and sparse, ``doph`` for sparse, and the
    SILK ``table_keys`` for every kind."""

    a: Any = None
    table_keys: Any = None
    item_keys: Any = None
    sig_keys: Any = None
    doph: Any = None

    def split_key(self, kind, gen, d, cfg):
        if kind == "dense":
            return None, (self.a,), self.table_keys
        return self.doph, (self.item_keys, self.sig_keys), self.table_keys


def jax_draws(key, d: int, cfg):
    """The reference's in-core dense draws for ``key``: (a, table_keys)
    as numpy, exactly as ``repro``'s LSHBucketer / silk_seeding make them."""
    import jax
    from repro.core import lsh
    from repro.utils.hashing import derive_hash_keys
    k_proj, k_silk = jax.random.split(key)
    a = np.asarray(lsh.qalsh_projections(k_proj, d, cfg.m))
    keys = np.asarray(derive_hash_keys(k_silk, (cfg.silk_l + 1, cfg.silk_k)))
    return a, keys


def jax_code_draws(key, kind: str, cfg) -> dict:
    """The reference's hetero or sparse draws for ``key`` as numpy
    uint32, exactly as ``repro``'s LSHBucketer / transforms / SILK
    derive them: ``item_keys`` (1, 2), ``sig_keys`` (bucket_l, bucket_k,
    2), ``table_keys`` (silk_l + 1, silk_k, 2) and, for sparse, ``doph``:
    the raw (2,) DOPH key that ``repro``'s sparse transform keeps (the port
    derives the hash pair from it, as the reference does)."""
    import jax
    from repro.utils.hashing import derive_hash_keys
    out = {}
    if kind == "hetero":
        k_item, k_sig, k_silk = jax.random.split(key, 3)
    else:
        k_doph, k_item, k_sig, k_silk = jax.random.split(key, 4)
        out["doph"] = jax.random.key_data(k_doph)
    out["item_keys"] = derive_hash_keys(k_item, (1,))
    out["sig_keys"] = derive_hash_keys(k_sig, (cfg.bucket_l, cfg.bucket_k))
    out["table_keys"] = derive_hash_keys(k_silk, (cfg.silk_l + 1, cfg.silk_k))
    return {k: np.asarray(v) for k, v in out.items()}


def injected_code_bucketer(draws: dict, device="cpu") -> InjectedBucketer:
    """An ``InjectedBucketer`` holding ``jax_code_draws``' arrays in the
    port's int64 carrier on ``device``."""
    return InjectedBucketer(**{k: carrier(v).to(device)
                               for k, v in draws.items()})


#: how far apart, in the port's router probabilities, an expert the port
#: would pick and the one the reference picked may lie where the two
#: differ: a bf16 model's router input differs from the reference's by an
#: ulp (2^-8 relative) at some elements, which moves a probability by up
#: to ~1e-2 (measured: 3.5e-4 to 9.7e-3 on the smoke configs); 2^-5 keeps
#: that margin thrice over and is far below the spread of a real choice
ROUTE_NEAR_TIE = 2.0 ** -5


class MoERoutes:
    """The reference's MoE expert choices, recorded, and the port held to
    or fed them.

    ``reference(fn)`` wraps a jitted reference function: while it runs
    (and is traced), ``repro.models.moe._dispatch_local`` also hands its
    top-k expert ids (``lax.top_k``: the lower id first on ties) to an
    ordered debug callback, so each MoE call's (T, k) ids land in
    ``self.recorded`` in call order.

    ``record()`` is a context in which the port's own choices are
    recorded instead (``chip_smoke.py`` holds the card to the CPU so).

    ``port()`` is a context in which the port's ``moe.top_k`` takes the
    recorded ids, one MoE call at a time, in order (setting ``next`` back
    replays them into a second port run); on leaving it every recorded
    call must have been taken, and the record is cleared. ``inject=False``: the
    port's own choice must equal the recorded one (as a set a token) and
    is used. ``inject=True``: the recorded ids are used (the gates are the
    port's own probabilities at them), and a token whose own choice
    differs counts as a near tie only if the port's k-th probability and
    its probability of the recorded expert lie within ``ROUTE_NEAR_TIE``
    (``self.flips`` lists those gaps). Expert choice is discrete, like a
    draw: a one-ulp difference upstream may flip it, and a flipped token
    then leaves every tolerance, so bf16 models are compared on the
    reference's routes and the flips are counted and bounded.
    """

    def __init__(self):
        self.recorded: list[np.ndarray] = []
        self.next = 0          # the recorded call the port's next MoE takes
        self.flips: list[float] = []

    def reference(self, fn):
        import jax
        from repro.models import moe as jmoe

        def record(ids):
            self.recorded.append(np.array(ids))

        def dispatch(xg, probs, k, e, cap):
            jax.debug.callback(record, jax.lax.top_k(probs, k)[1],
                               ordered=True)
            return original(xg, probs, k, e, cap)

        original = jmoe._dispatch_local

        def run(*args):
            jmoe._dispatch_local = dispatch
            try:
                out = fn(*args)
                jax.effects_barrier()
            finally:
                jmoe._dispatch_local = original
            return out
        return run

    @contextlib.contextmanager
    def record(self):
        from repro_torch.models import moe as tmoe
        own_top_k = tmoe.top_k

        def top_k(probs, k):
            vals, ids = own_top_k(probs, k)
            self.recorded.append(ids.cpu().numpy())
            return vals, ids

        tmoe.top_k = top_k
        try:
            yield self
        finally:
            tmoe.top_k = own_top_k

    @contextlib.contextmanager
    def port(self, inject: bool):
        from repro_torch.models import moe as tmoe
        own_top_k = tmoe.top_k

        def top_k(probs, k):
            assert self.next < len(self.recorded), \
                "the port ran an MoE call that was not recorded"
            want = torch.from_numpy(np.asarray(self.recorded[self.next])
                                    .reshape(-1, k))
            self.next += 1
            want = want.to(device=probs.device, dtype=torch.int64)
            vals, ids = own_top_k(probs, k)
            differ = (torch.sort(ids, -1).values
                      != torch.sort(want, -1).values).any(-1)
            if not inject:
                assert not bool(differ.any()), \
                    f"routes differ at tokens {differ.nonzero().tolist()}"
                return vals, ids
            for r in differ.nonzero().flatten().tolist():
                gap = float(vals[r, -1] - probs[r].gather(0, want[r]).min())
                assert gap <= ROUTE_NEAR_TIE, f"token {r}: a route gap {gap}"
                self.flips.append(gap)
            return probs.gather(-1, want), want

        tmoe.top_k = top_k
        try:
            yield self
        finally:
            tmoe.top_k = own_top_k
        assert self.next == len(self.recorded), \
            f"{len(self.recorded) - self.next} recorded MoE calls the port " \
            "did not make"
        self.recorded.clear()
        self.next = 0
