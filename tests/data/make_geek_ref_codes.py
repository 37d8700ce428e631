"""Regenerate the code-space reference fixtures ``tests/data/geek_ref_hetero/``
and ``tests/data/geek_ref_sparse/``.

Each is a GEEK model fitted by the JAX package ``repro`` and saved with its
``save_model``, plus 256 queries and the reference's predict labels and
distances on them:

- hetero (GeoNames-shaped: 5 numeric + 4 categorical columns, equality
  Hamming): the queries are raw parts (``x_num.npy``, ``x_cat.npy``), which
  the PyTorch port codes with the restored quantile boundaries;
- sparse (URL-shaped sets, 16-bit DOPH codes, packed Hamming): the
  queries are raw sets (``sets.npy``, ``mask.npy``), which the port codes
  under the checkpoint's JAX key, and the reference's own codes of them
  (``codes.npy``).

The port must reproduce both exactly (``tests/test_torch_fit_codes.py`` on
the CPU, ``chip_smoke.py`` on the card). Run from the repository root::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/data/make_geek_ref_codes.py
"""
import dataclasses
import os
import shutil

import jax
import numpy as np

from repro import GEEK, GeekConfig, HeteroData, SparseData, predict, save_model
from repro.data.synthetic import geonames_like, url_like

HERE = os.path.dirname(os.path.abspath(__file__))
CFG = GeekConfig(bucket_l=10, k_max=64, pair_cap=1 << 15)
N_FIT, N_QUERY = 4096, 256


def write(name, model, est, queries: dict, labels, dists):
    out = os.path.join(HERE, name)
    if os.path.exists(out):
        shutil.rmtree(out)
    save_model(os.path.join(out, "ckpt"), model)
    for fname, arr in queries.items():
        np.save(os.path.join(out, f"{fname}.npy"), np.asarray(arr))
    np.save(os.path.join(out, "labels.npy"), np.asarray(labels))
    np.save(os.path.join(out, "dists.npy"), np.asarray(dists))
    print(f"{name}: k*={int(model.k_star)} "
          f"overflow={int(est.result_.overflow)} impl={model.impl} "
          f"bits={model.code_bits} config={dataclasses.asdict(CFG)} -> {out}")


def main():
    h = geonames_like(jax.random.PRNGKey(21), n=N_FIT + N_QUERY, k=16)
    x_num, x_cat = np.asarray(h.x_num), np.asarray(h.x_cat)
    est = GEEK(CFG)
    model = est.fit(HeteroData(x_num[:N_FIT], x_cat[:N_FIT]),
                    jax.random.PRNGKey(22))
    q = dict(x_num=x_num[N_FIT:], x_cat=x_cat[N_FIT:])
    labels, dists = est.predict(HeteroData(q["x_num"], q["x_cat"]))
    write("geek_ref_hetero", model, est, q, labels, dists)

    s = url_like(jax.random.PRNGKey(31), n=N_FIT + N_QUERY, k=16)
    sets, mask = np.asarray(s.sets), np.asarray(s.mask)
    est = GEEK(CFG)
    model = est.fit(SparseData(sets[:N_FIT], mask[:N_FIT]),
                    jax.random.PRNGKey(32))
    codes = np.asarray(model.encode(sets[N_FIT:], mask[N_FIT:]))
    labels, dists = predict(model, codes)
    write("geek_ref_sparse", model, est,
          dict(codes=codes, sets=sets[N_FIT:], mask=mask[N_FIT:]), labels,
          dists)


if __name__ == "__main__":
    main()
