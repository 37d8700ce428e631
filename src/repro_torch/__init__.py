"""GEEK ported to PyTorch and CUDA, beside the JAX reference ``repro``.

The in-core and sharded fits and exact predict of dense, heterogeneous
and sparse data, on an NVIDIA card by default::

    from repro_torch import GEEK, DenseData, GeekConfig, HeteroData, predict

    est = GEEK(GeekConfig(k_max=256))          # device="cpu" for the plain path
    model = est.fit(DenseData(x), 0)
    labels, dists = predict(model, new_x)
    model = est.fit(HeteroData(x_num, x_cat), 0)   # or SparseData(sets, mask)
    labels, dists = est.predict(HeteroData(new_num, new_cat))

Sharded over the ranks of a ``torch.distributed`` process group (NCCL on
cards, gloo on CPU processes), called on every rank with the same data::

    from repro_torch import make_fit_dense, make_mesh, make_predict_sharded

    mesh = make_mesh()                         # the default process group
    model = est.fit(DenseData(x), 0, mesh=mesh)
    labels, dists = make_predict_sharded(mesh)(model, new_x)
    res = make_fit_dense(mesh, cfg)(x, 0)      # the paper's table-sync fit

Online KV-cache clustering inside an LM's decode, for any of the ten
architectures (attention, Mamba and RWKV6 mixers, MLP and MoE
feed-forwards; weights drawn from a seed or carried from ``repro``)::

    from repro_torch import clustered_decode, get_arch, init_params

    cfg = get_arch("qwen3_0_6b")               # or a hybrid: "jamba_v0_1_52b"
    params = init_params(cfg, 0)               # device="cpu" for the plain path
    out = clustered_decode(params, cfg, tokens, prompt_len=2048)
    out["ppl"], out["mean_k_star"], out["compression"]
    count_params(get_arch("kimi_k2_1t_a32b"))  # shapes only (meta device)

The package imports ``torch``, ``numpy`` and the standard library only;
its module layout mirrors ``repro``'s so each module's counterpart is
found by name. The hand-written CUDA kernels live in
``repro_torch.kernels`` and are built on first use.
"""
from repro_torch.checkpoint.manager import restore_model, save_model
from repro_torch.configs import get_arch
from repro_torch.core.api import (GEEK, DenseData, HeteroData, KernelAssigner,
                                  KMeansPPSeeder, LSHBucketer,
                                  ScalableKMeansPPSeeder, SILKSeeder,
                                  SparseData)
from repro_torch.core.distributed import make_fit_dense, make_predict_sharded
from repro_torch.core.geek import GeekConfig, GeekResult
from repro_torch.core.model import GeekModel, predict
from repro_torch.models.model import (count_active_params, count_params,
                                      init_params)
from repro_torch.serve.kv_cluster import OnlineKVCluster, clustered_decode
from repro_torch.utils.compat import Mesh, make_mesh

__all__ = sorted(["DenseData", "GEEK", "GeekConfig", "GeekModel", "GeekResult",
                  "HeteroData", "KMeansPPSeeder", "KernelAssigner",
                  "LSHBucketer", "Mesh", "OnlineKVCluster", "SILKSeeder",
                  "ScalableKMeansPPSeeder", "SparseData",
                  "clustered_decode", "count_active_params",
                  "count_params", "get_arch", "init_params",
                  "make_fit_dense", "make_mesh", "make_predict_sharded",
                  "predict", "restore_model", "save_model"])
