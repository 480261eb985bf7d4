"""GCN on Cora [arXiv:1609.02907]: 2 layers, 16 hidden, mean agg, sym norm."""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="gcn-cora",
    num_layers=2,
    d_hidden=16,
    num_classes=7,
    aggregator="mean",
    norm="sym",
)

REDUCED = GNNConfig(
    name="gcn-cora-reduced",
    num_layers=2,
    d_hidden=8,
    num_classes=4,
    aggregator="mean",
    norm="sym",
    dropout=0.0,
)
