"""dlrm-rm2 [recsys] n_dense=13 n_sparse=26 embed_dim=64
bot_mlp=13-512-256-64 top_mlp=512-512-256-1 interaction=dot
[arXiv:1906.00091; paper].  Criteo-Kaggle cardinalities."""
from ..models.recsys import CRITEO_KAGGLE_VOCABS, DLRMConfig
from .families import DLRMSpec
from .registry import register

SPEC = register(DLRMSpec(
    name="dlrm-rm2",
    cfg=DLRMConfig(
        name="dlrm-rm2", n_dense=13, embed_dim=64,
        bot_mlp=(13, 512, 256, 64), top_mlp=(512, 512, 256, 1),
        vocab_sizes=CRITEO_KAGGLE_VOCABS,
    ),
))
