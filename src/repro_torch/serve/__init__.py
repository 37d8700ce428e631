"""``repro_torch.serve``: online KV-cache clustering inside LM decode.

The counterpart of ``repro.serve``'s ``kv_cluster`` names; the serving
tier (``ClusterServer``, ``ModelRegistry``, the HTTP front end) is not
ported yet (ROADMAP.md, Queue 1 item 13).
"""
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

__all__ = ["KVState", "LayerKVCluster", "OnlineKVCluster",
           "clustered_attention", "clustered_decode", "default_kv_config",
           "ema_update", "make_layer_step", "stack_heads"]
