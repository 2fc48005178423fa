"""BERT family (port of ``paddle_tpu/models/bert.py``): the reference
ecosystem model, built with the Paddle API on ``nn.TransformerEncoder``.

Where the JAX module computes on ``jnp`` arrays (the attention mask's
arithmetic, the pretraining loss's label mask) the port computes with
torch on the Tensors' ``_data``.  The loss keeps the reference's host
read of the masked-token count: one device-to-host sync a step.
"""

import torch

from .. import nn
from ..core.tensor import _wrap
from ..nn import functional as F
from ..nn.initializer import Normal
from ..nn.layer_base import ParamAttr


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act="gelu",
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 initializer_range=0.02, layer_norm_eps=1e-12,
                 num_labels=2):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.initializer_range = initializer_range
        self.layer_norm_eps = layer_norm_eps
        self.num_labels = num_labels


class BertEmbeddings(nn.Layer):
    def __init__(self, config):
        super().__init__()
        init = ParamAttr(initializer=Normal(0.0, config.initializer_range))
        self.word_embeddings = nn.Embedding(config.vocab_size,
                                            config.hidden_size,
                                            weight_attr=init)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, config.hidden_size,
            weight_attr=init)
        self.token_type_embeddings = nn.Embedding(
            config.type_vocab_size, config.hidden_size, weight_attr=init)
        self.layer_norm = nn.LayerNorm(config.hidden_size,
                                       epsilon=config.layer_norm_eps)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        t = input_ids.shape[-1]
        from ..ops.creation import zeros_like
        if position_ids is None:
            position_ids = _wrap(torch.arange(t, dtype=torch.int32,
                                              device=input_ids._data.device))
        if token_type_ids is None:
            token_type_ids = zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertPooler(nn.Layer):
    def __init__(self, config):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.hidden_size)

    def forward(self, hidden):
        from ..ops.math import tanh
        return tanh(self.dense(hidden[:, 0]))


class BertModel(nn.Layer):
    def __init__(self, config):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config)
        enc_layer = nn.TransformerEncoderLayer(
            config.hidden_size, config.num_attention_heads,
            config.intermediate_size, dropout=config.hidden_dropout_prob,
            attn_dropout=config.attention_probs_dropout_prob,
            activation=config.hidden_act, normalize_before=False)
        self.encoder = nn.TransformerEncoder(enc_layer,
                                             config.num_hidden_layers)
        self.pooler = BertPooler(config)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None):
        if attention_mask is not None and attention_mask.ndim == 2:
            # [B, T] 1/0 -> additive [B, 1, 1, T]
            m = attention_mask._data.float()
            attention_mask = _wrap((1.0 - m)[:, None, None, :] * -1e4)
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        seq = self.encoder(x, src_mask=attention_mask)
        return seq, self.pooler(seq)


class BertForSequenceClassification(nn.Layer):
    def __init__(self, config):
        super().__init__()
        self.bert = BertModel(config)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)
        self.classifier = nn.Linear(config.hidden_size, config.num_labels)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))


class BertForPretraining(nn.Layer):
    """MLM + NSP heads (tied MLM decoder)."""

    def __init__(self, config):
        super().__init__()
        self.bert = BertModel(config)
        self.transform = nn.Linear(config.hidden_size, config.hidden_size)
        self.transform_ln = nn.LayerNorm(config.hidden_size,
                                         epsilon=config.layer_norm_eps)
        self.nsp = nn.Linear(config.hidden_size, 2)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.transform_ln(F.gelu(self.transform(seq)))
        w = self.bert.embeddings.word_embeddings.weight
        mlm_logits = F.linear(h, w.T)
        nsp_logits = self.nsp(pooled)
        return mlm_logits, nsp_logits

    def loss(self, mlm_logits, nsp_logits, mlm_labels, nsp_labels,
             ignore_index=-100):
        v = mlm_logits.shape[-1]
        flat_logits = mlm_logits.reshape([-1, v])
        flat_labels = mlm_labels.reshape([-1])
        labels = flat_labels._data
        mask = _wrap(labels != ignore_index)
        safe = _wrap(torch.where(labels == ignore_index,
                                 torch.zeros_like(labels), labels))
        per_tok = F.cross_entropy(flat_logits, safe, reduction="none")
        count = max(1, int(mask._data.sum()))   # the one host read a step
        mlm = (per_tok * mask.astype("float32")).sum() / _wrap(
            torch.tensor(float(count), device=labels.device))
        nsp = F.cross_entropy(nsp_logits, nsp_labels)
        return mlm + nsp


def bert_base_config(**kw):
    return BertConfig(**kw)


def bert_tiny_config(**kw):
    cfg = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=128,
               max_position_embeddings=64,
               hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    cfg.update(kw)
    return BertConfig(**cfg)


def bert_base(**kw):
    return BertModel(bert_base_config(**kw))


def bert_tiny(**kw):
    return BertModel(bert_tiny_config(**kw))
