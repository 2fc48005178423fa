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
from .conformer import Conformer, conformer_tiny
from .deepspeech import DeepSpeech2, deepspeech2_tiny
from .gpt import (
    GPTConfig,
    GPTForCausalLM,
    gpt_1_3b,
    gpt_6_7b,
    gpt_124m,
    gpt_350m,
    gpt_tiny,
)

__all__ = ["BertConfig", "BertForPretraining",
           "BertForSequenceClassification", "BertModel", "Conformer",
           "DeepSpeech2", "GPTConfig", "GPTForCausalLM", "bert_base",
           "bert_base_config", "bert_tiny", "bert_tiny_config",
           "conformer_tiny", "deepspeech2_tiny", "gpt_1_3b", "gpt_6_7b",
           "gpt_124m", "gpt_350m", "gpt_tiny"]
