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
from .deepfm import DeepFM
from .deepspeech import DeepSpeech2, deepspeech2_tiny
from .gpt import (
    GPTConfig,
    GPTForCausalLM,
    GPTModel,
    gpt_1_3b,
    gpt_6_7b,
    gpt_124m,
    gpt_350m,
    gpt_tiny,
)
from .llama import (
    LlamaConfig,
    LlamaForCausalLM,
    LlamaModel,
    llama_7b,
    llama_160m,
    llama_tiny,
)
from .wide_deep import WideDeep

__all__ = ["BertConfig", "BertForPretraining",
           "BertForSequenceClassification", "BertModel", "Conformer",
           "DeepFM", "DeepSpeech2", "GPTConfig", "GPTForCausalLM",
           "GPTModel", "LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "WideDeep", "bert_base", "bert_base_config", "bert_tiny",
           "bert_tiny_config", "conformer_tiny", "deepspeech2_tiny",
           "gpt_1_3b", "gpt_6_7b", "gpt_124m", "gpt_350m", "gpt_tiny",
           "llama_7b", "llama_160m", "llama_tiny"]
