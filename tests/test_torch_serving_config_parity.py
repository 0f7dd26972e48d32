"""Port parity: ``serving.chunked_prefill`` parsed by the port's
``ServingConfig.from_dict`` exactly as the JAX package parses it: a key
that is present and not None turns chunked prefill on by default, a falsy
value is read as an empty block, and a truthy value that is not a dict
raises ``ConfigError``.
"""

import pytest
import torch

from deepspeed_tpu.config.config import ConfigError as JaxConfigError
from deepspeed_tpu.config.config import ServingConfig as JaxServingConfig
from deepspeed_tpu_torch.config import ConfigError, ServingConfig

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "chunked", [None, False, 0, {}, {"enabled": False},
                {"token_budget": 8}, True, 16],
    ids=["none", "false", "zero", "empty", "disabled", "budget8", "true",
         "sixteen"])
def test_chunked_prefill_parsed_as_the_reference(chunked):
    d = {"chunked_prefill": chunked}
    try:
        want = JaxServingConfig.from_dict(dict(d))
    except JaxConfigError as e:
        with pytest.raises(ConfigError, match="must be a dict"):
            ServingConfig.from_dict(dict(d))
        assert "must be a dict" in str(e)
        return
    got = ServingConfig.from_dict(dict(d))
    assert (got.chunked_prefill, got.chunked_token_budget) == (
        want.chunked_prefill, want.chunked_token_budget)
