"""The port's GPT presets carry the JAX presets' fields, field for field:
``gpt_350m``, ``gpt_1_3b`` and ``gpt_6_7b`` (the JAX package's
north-star configuration), beside ``gpt_tiny`` and ``gpt_124m``.  The
configurations are compared without building the large models: each
preset's ``GPTConfig`` is taken from the call, its weights never made
(the 6.7B model's 13.4 GB of bf16 weights are built only on the card,
``chip_smoke.py``'s ``gpt_6_7b`` phase)."""

from unittest import mock

import pytest

import paddle_tpu.models.gpt as JG

import paddle_tpu_torch.models as PM
import paddle_tpu_torch.models.gpt as PG

PRESETS = ["gpt_tiny", "gpt_124m", "gpt_350m", "gpt_1_3b", "gpt_6_7b"]
FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_attention_heads",
          "intermediate_size", "max_position_embeddings",
          "hidden_dropout_prob", "attention_probs_dropout_prob",
          "initializer_range", "layer_norm_epsilon")


def _config(module, name, **kw):
    """The GPTConfig ``module.name(**kw)`` would build its model from."""
    seen = []

    def capture(config, *a, **k):
        seen.append(config)

    with mock.patch.object(module, "GPTForCausalLM", capture):
        getattr(module, name)(**kw)
    return seen[0]


@pytest.mark.parametrize("name", PRESETS)
def test_preset_fields_match_reference(name):
    port, ref = _config(PG, name), _config(JG, name)
    for f in FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
    assert port.head_dim == ref.hidden_size // ref.num_attention_heads
    assert getattr(PM, name) is getattr(PG, name)


def test_overrides_reach_the_config():
    port = _config(PG, "gpt_6_7b", num_layers=2)
    ref = _config(JG, "gpt_6_7b", num_layers=2)
    assert port.num_layers == ref.num_layers == 2
    assert port.hidden_size == 4096 and port.head_dim == 128


def test_gpt_config_takes_the_jax_keywords():
    """ROADMAP C13: ``GPTConfig`` takes the JAX config's
    ``use_flash_attention``, ``sequence_parallel`` and ``cp_mode``.  The
    first is stored and read nowhere, as in the JAX package;
    ``gpt_tiny(use_flash_attention=False)`` builds (the reference
    exporter test's model) with the JAX config's value.  The other two
    select the sequence- and context-parallel paths (ROADMAP A23b-6b):
    each builds and stores the JAX config's value."""
    model = PG.gpt_tiny(device="cpu", use_flash_attention=False)
    ref = _config(JG, "gpt_tiny", use_flash_attention=False)
    assert model.config.use_flash_attention is False
    assert ref.use_flash_attention is False
    assert PG.GPTConfig().use_flash_attention is True
    for kw in ({"sequence_parallel": True}, {"cp_mode": "ring"}):
        (key, value), = kw.items()
        assert getattr(PG.gpt_tiny(device="cpu", **kw).config, key) == \
            getattr(_config(JG, "gpt_tiny", **kw), key) == value
