"""Core pipeline: LSH buckets, SILK seeding, centers and assignment, the facade.

Re-exports every name of ``repro.core.__all__``, so that each import
of a name from the reference's ``repro.core`` works from
``repro_torch.core``; the surface is locked by
``tests/test_torch_api_surface.py``.
"""
from repro_torch.core.api import (  # noqa: F401
    GEEK,
    DenseData,
    HeteroData,
    KernelAssigner,
    KMeansPPSeeder,
    LSHBucketer,
    ScalableKMeansPPSeeder,
    SILKSeeder,
    SparseData,
    as_dataset,
    discover,
)
from repro_torch.core.geek import GeekConfig, GeekResult  # noqa: F401
from repro_torch.core.model import (  # noqa: F401
    CenterIndex,
    GeekModel,
    NumericDiscretizer,
    build_center_index,
    build_model,
    patch_probed_fallback,
    predict,
    predict_probed,
    update_centers,
)
from repro_torch.core.silk import SeedPairs, Seeds, silk_seeding  # noqa: F401
from repro_torch.core.transform import (  # noqa: F401
    HeteroTransform,
    IdentityTransform,
    SparseTransform,
)

#: the public surface (sorted; locked by tests/test_torch_api_surface.py)
__all__ = [
    "CenterIndex",
    "DenseData",
    "GEEK",
    "GeekConfig",
    "GeekModel",
    "GeekResult",
    "HeteroData",
    "HeteroTransform",
    "IdentityTransform",
    "KMeansPPSeeder",
    "KernelAssigner",
    "LSHBucketer",
    "NumericDiscretizer",
    "SILKSeeder",
    "ScalableKMeansPPSeeder",
    "SeedPairs",
    "Seeds",
    "SparseData",
    "SparseTransform",
    "as_dataset",
    "build_center_index",
    "build_model",
    "discover",
    "patch_probed_fallback",
    "predict",
    "predict_probed",
    "silk_seeding",
    "update_centers",
]
