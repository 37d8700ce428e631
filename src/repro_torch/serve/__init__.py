"""``repro_torch.serve``: the serving tier and online KV-cache clustering.

The counterpart of ``repro.serve``, every name of its ``__all__`` and the
port's stacked-layer KV names (locked by
``tests/test_torch_api_surface.py``)::

    from repro_torch.serve import ClusterServer

    server = ClusterServer(model_or_ckpt, probes=None, max_batch=4096,
                           deadline_ms=5.0)          # device="cpu" to ask
    fut = server.submit(parts)        # single row or small batch
    fut.result().labels               # resolved per micro-batch
    server.swap(new_ckpt_dir)         # atomic between micro-batches
    server.close()

``ClusterServer`` micro-batches requests onto a pad ladder with
double-buffered dispatch through the port's kernels; ``ModelRegistry``
is the hot-swap point; ``WorkerPool`` runs one server per device behind
the shared registry, ``ClusterFrontend`` is the standard-library HTTP
shim over either, and ``RefitAutopilot`` refits from served traffic and
publishes only validated models. ``clustered_decode`` and its parts
cluster an LM's KV cache online.
"""
from repro_torch.serve.autopilot import RefitAutopilot  # noqa: F401
from repro_torch.serve.dispatch import WorkerPool  # noqa: F401
from repro_torch.serve.engine import (  # noqa: F401
    Assignment,
    ClusterServer,
    ServerClosedError,
    pad_ladder,
)
from repro_torch.serve.frontend import ClusterFrontend  # noqa: F401
from repro_torch.serve.kv_cluster import (  # noqa: F401
    KVState,
    LayerKVCluster,
    OnlineKVCluster,
    clustered_attention,
    clustered_decode,
    default_kv_config,
    ema_update,
    make_layer_step,
    stack_heads,
)
from repro_torch.serve.registry import ModelRecord, ModelRegistry  # noqa: F401

#: the serving surface (sorted; locked by tests/test_torch_api_surface.py)
__all__ = [
    "Assignment",
    "ClusterFrontend",
    "ClusterServer",
    "KVState",
    "LayerKVCluster",
    "ModelRecord",
    "ModelRegistry",
    "OnlineKVCluster",
    "RefitAutopilot",
    "ServerClosedError",
    "WorkerPool",
    "clustered_attention",
    "clustered_decode",
    "default_kv_config",
    "ema_update",
    "make_layer_step",
    "pad_ladder",
    "stack_heads",
]
