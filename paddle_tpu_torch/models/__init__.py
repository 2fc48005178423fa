from .gpt import GPTConfig, GPTForCausalLM, gpt_124m, gpt_tiny

__all__ = ["GPTConfig", "GPTForCausalLM", "gpt_124m", "gpt_tiny"]
