"""DeepFM CTR model over the PS sparse tables (BASELINE.md sparse/PS
config, alongside Wide&Deep).

Reference: PaddleRec DeepFM over the PS stack (SURVEY §2.7 parameter
server).  Factorization-machine second-order term + DNN over shared
sparse embeddings; both the FM first-order weights (dim 1) and the
feature embeddings (dim k) live in host-side sparse tables
(DistributedEmbedding), so 100B-feature vocabularies never touch HBM —
the device sees only the pulled dense rows.
"""

from .. import nn
from ..distributed.ps import DistributedEmbedding


class DeepFM(nn.Layer):
    def __init__(self, sparse_feature_dim=8, num_slots=8,
                 hidden_sizes=(64, 32), table_lr=0.05,
                 table_optimizer="adagrad", table=None, first_order_table=None):
        super().__init__()
        self.num_slots = num_slots
        # first-order term: per-feature scalar weight
        self.fo_table = DistributedEmbedding(
            1, optimizer=table_optimizer, learning_rate=table_lr,
            table=first_order_table)
        # shared embeddings: FM second-order + DNN input
        self.emb_table = DistributedEmbedding(
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
        """slot_ids: int64 [batch, num_slots] -> logits [batch, 1]."""
        b = slot_ids.shape[0]
        first = self.fo_table(slot_ids).reshape([b, -1]) \
            .sum(axis=-1, keepdim=True)                       # [B, 1]
        emb = self.emb_table(slot_ids)                        # [B, S, K]
        # FM second order: 0.5 * ((sum_i v_i)^2 - sum_i v_i^2) . 1
        sum_sq = emb.sum(axis=1) ** 2                         # [B, K]
        sq_sum = (emb ** 2).sum(axis=1)                       # [B, K]
        second = 0.5 * (sum_sq - sq_sum).sum(axis=-1, keepdim=True)
        deep = self.dnn(emb.reshape([b, -1]))                 # [B, 1]
        return first + second + deep

    def loss(self, logits, labels):
        from ..nn import functional as F

        return F.binary_cross_entropy_with_logits(
            logits.reshape([-1]), labels.reshape([-1]))
