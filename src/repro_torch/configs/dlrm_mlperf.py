"""dlrm-mlperf [recsys] n_dense=13 n_sparse=26 embed_dim=128
bot_mlp=13-512-256-128 top_mlp=1024-1024-512-256-1 interaction=dot —
MLPerf DLRM benchmark config (Criteo 1TB) [arXiv:1906.00091; paper]."""
from ..models.recsys import CRITEO_TB_VOCABS, DLRMConfig
from .families import DLRMSpec
from .registry import register

SPEC = register(DLRMSpec(
    name="dlrm-mlperf",
    cfg=DLRMConfig(
        name="dlrm-mlperf", n_dense=13, embed_dim=128,
        bot_mlp=(13, 512, 256, 128), top_mlp=(1024, 1024, 512, 256, 1),
        vocab_sizes=CRITEO_TB_VOCABS,
    ),
))
