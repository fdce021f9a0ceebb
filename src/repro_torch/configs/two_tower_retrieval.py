"""two-tower-retrieval [recsys] embed_dim=256 tower_mlp=1024-512-256
interaction=dot — sampled-softmax retrieval [RecSys'19 (YouTube);
unverified].  ``retrieval_cand`` is also servable through the paper's
IP-DiskANN streaming index (see examples/distributed_serving_torch.py)."""
from ..models.recsys import TwoTowerConfig
from .families import TwoTowerSpec
from .registry import register

SPEC = register(TwoTowerSpec(
    name="two-tower-retrieval",
    cfg=TwoTowerConfig(
        name="two-tower-retrieval", embed_dim=256,
        tower_mlp=(1024, 512, 256), user_vocab=1_000_000,
        item_vocab=1_000_000,
    ),
))
