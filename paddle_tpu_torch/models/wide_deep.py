"""Wide&Deep — the PS/recsys benchmark config (BASELINE.md sparse/PS row).

Reference: the reference's PS-mode CTR models (test/ps/ps_dnn_trainer.py
pattern) — wide (linear over sparse features) + deep (embeddings -> MLP).
Sparse parameters live in the host PS table (DistributedEmbedding);
dense parameters train on device.
"""

from .. import nn
from ..distributed.ps import DistributedEmbedding, SparseTable


class WideDeep(nn.Layer):
    def __init__(self, sparse_feature_dim=8, num_slots=8,
                 hidden_sizes=(64, 32), table_lr=0.05,
                 table_optimizer="adagrad", table=None, wide_table=None):
        super().__init__()
        self.num_slots = num_slots
        # wide part: per-feature scalar weights in their own 1-dim table.
        # Multi-host runs must pass BOTH tables as DistributedSparseTable
        # shards — a local wide table would silently diverge across hosts.
        self.wide_table = DistributedEmbedding(
            1, optimizer=table_optimizer, learning_rate=table_lr,
            table=wide_table)
        # deep part: shared embedding table over all slots; ``table`` lets a
        # multi-host run pass a DistributedSparseTable (sharded PS service)
        self.deep_table = DistributedEmbedding(
            sparse_feature_dim, optimizer=table_optimizer,
            learning_rate=table_lr, table=table)
        layers = []
        in_dim = sparse_feature_dim * num_slots
        for h in hidden_sizes:
            layers += [nn.Linear(in_dim, h), nn.ReLU()]
            in_dim = h
        layers.append(nn.Linear(in_dim, 1))
        self.dnn = nn.Sequential(*layers)

    def forward(self, slot_ids):
        """slot_ids: int64 [batch, num_slots] feature ids."""
        b = slot_ids.shape[0]
        wide = self.wide_table(slot_ids)          # [B, S, 1]
        wide_logit = wide.reshape([b, -1]).sum(axis=-1, keepdim=True)
        deep = self.deep_table(slot_ids)          # [B, S, D]
        deep_logit = self.dnn(deep.reshape([b, -1]))
        return wide_logit + deep_logit
