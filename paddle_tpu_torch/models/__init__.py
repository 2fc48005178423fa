from .bert import (
    BertConfig,
    BertForPretraining,
    BertForSequenceClassification,
    BertModel,
    bert_base,
    bert_base_config,
    bert_tiny,
    bert_tiny_config,
)
from .gpt import GPTConfig, GPTForCausalLM, gpt_124m, gpt_tiny

__all__ = ["BertConfig", "BertForPretraining",
           "BertForSequenceClassification", "BertModel", "GPTConfig",
           "GPTForCausalLM", "bert_base", "bert_base_config", "bert_tiny",
           "bert_tiny_config", "gpt_124m", "gpt_tiny"]
