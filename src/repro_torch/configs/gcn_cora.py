"""gcn-cora [gnn] n_layers=2 d_hidden=16 aggregator=mean norm=sym
[arXiv:1609.02907; paper].  Per-shape feature dims: cora 1433 /
ogb-products 100 / reddit-style minibatch 602 / molecule 32."""
from .families import GNNSpec
from .registry import register

SPEC = register(GNNSpec(name="gcn-cora", n_layers=2, d_hidden=16))
