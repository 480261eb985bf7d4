"""The paper's own pipeline as a selectable config (IndexConfig defaults)."""
import math
from repro_torch.core.search import IndexConfig

CONFIG = IndexConfig(q=math.inf, metric="euclidean")
REDUCED = IndexConfig(
    q=math.inf, metric="euclidean", proj_sample=256, knn_k=8, num_hops=4,
    embed_dim=16, hidden=(64,), train_steps=200, batch_pairs=256,
)
