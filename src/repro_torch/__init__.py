"""GEEK ported to PyTorch and CUDA, beside the JAX reference ``repro``.

The in-core fit and exact predict of dense, heterogeneous and sparse
data, on an NVIDIA card by default::

    from repro_torch import GEEK, DenseData, GeekConfig, HeteroData, predict

    est = GEEK(GeekConfig(k_max=256))          # device="cpu" for the plain path
    model = est.fit(DenseData(x), 0)
    labels, dists = predict(model, new_x)
    model = est.fit(HeteroData(x_num, x_cat), 0)   # or SparseData(sets, mask)
    labels, dists = est.predict(HeteroData(new_num, new_cat))

The package imports ``torch``, ``numpy`` and the standard library only;
its module layout mirrors ``repro``'s so each module's counterpart is
found by name. The hand-written CUDA kernels live in
``repro_torch.kernels`` and are built on first use.
"""
from repro_torch.checkpoint.manager import restore_model, save_model
from repro_torch.core.api import (GEEK, DenseData, HeteroData, KernelAssigner,
                                  LSHBucketer, SILKSeeder, SparseData)
from repro_torch.core.geek import GeekConfig, GeekResult
from repro_torch.core.model import GeekModel, predict

__all__ = sorted(["DenseData", "GEEK", "GeekConfig", "GeekModel", "GeekResult",
                  "HeteroData", "KernelAssigner", "LSHBucketer", "SILKSeeder",
                  "SparseData", "predict", "restore_model", "save_model"])
