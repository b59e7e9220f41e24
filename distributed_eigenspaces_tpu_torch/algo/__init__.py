"""Algorithm layer: the online distributed PCA outer loop and the one-shot
round (the reference's ``algo`` exports)."""

from distributed_eigenspaces_tpu_torch.algo.online import (
    OnlineState,
    one_shot_round,
    online_distributed_pca,
)

__all__ = ["online_distributed_pca", "one_shot_round", "OnlineState"]
