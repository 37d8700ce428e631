"""Regenerate the reference fixture ``tests/data/geek_ref_dense/``.

A dense GEEK model fitted by the JAX package ``repro`` (k_max = 64,
d = 128) and saved with its ``save_model``, plus 256 query rows and the
reference's predict labels and distances on them. The PyTorch port
restores the checkpoint and must reproduce those labels (on the CPU in
``tests/test_torch_fit.py``, on the card in ``chip_smoke.py``).

Run from the repository root::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/data/make_geek_ref_dense.py
"""
import dataclasses
import os
import shutil

import jax
import numpy as np

from repro import GEEK, DenseData, GeekConfig, predict, save_model
from repro.data.synthetic import sift_like

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "geek_ref_dense")
CFG = GeekConfig(m=16, t=32, k_max=64, pair_cap=1 << 16)
N_FIT, N_QUERY = 4096, 256


def main():
    data = sift_like(jax.random.PRNGKey(11), n=N_FIT + N_QUERY, k=64)
    x = np.asarray(data.x)
    est = GEEK(CFG)
    model = est.fit(DenseData(x[:N_FIT]), jax.random.PRNGKey(12))
    queries = x[N_FIT:]
    labels, dists = predict(model, queries)
    if os.path.exists(OUT):
        shutil.rmtree(OUT)
    save_model(os.path.join(OUT, "ckpt"), model)
    np.save(os.path.join(OUT, "queries.npy"), queries)
    np.save(os.path.join(OUT, "labels.npy"), np.asarray(labels))
    np.save(os.path.join(OUT, "dists.npy"), np.asarray(dists))
    print(f"k*={int(model.k_star)} overflow={int(est.result_.overflow)} "
          f"config={dataclasses.asdict(CFG)} -> {OUT}")


if __name__ == "__main__":
    main()
