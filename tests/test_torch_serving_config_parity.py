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


@pytest.mark.parametrize("key", ["speculative", "resilience"])
@pytest.mark.parametrize(
    "block", [None, {}, {"k": 2}, 0, False, {"enabled": True},
              {"enabled": False, "k": 2}, 3],
    ids=["none", "empty", "k2", "zero", "false", "enabled", "disabled",
         "three"])
def test_speculative_and_resilience_parsed_as_the_reference(key, block):
    """``speculative`` is on only with ``enabled: true``; ``resilience``
    with ``enabled: true`` or, without ``enabled``, for a non-empty block;
    a falsy value of either is an empty block and a truthy value that is
    not a dict raises "must be a dict"; an unknown resilience key raises.
    Where the reference parses, the port parses to the same switch and
    fields."""
    d = {key: block}
    try:
        want = JaxServingConfig.from_dict(dict(d))
    except JaxConfigError as e:
        match = ("must be a dict" if "must be a dict" in str(e)
                 else "unknown serving.resilience keys")
        assert match in str(e)
        with pytest.raises(ConfigError, match=match):
            ServingConfig.from_dict(dict(d))
        return
    got = ServingConfig.from_dict(dict(d))
    prefix = "spec_" if key == "speculative" else "resil"
    fields = [f for f in vars(got) if f.startswith(prefix)]
    assert len(fields) == (3 if key == "speculative" else 8)
    assert {f: getattr(got, f) for f in fields} == \
        {f: getattr(want, f) for f in fields}


@pytest.mark.parametrize("config,on", [
    ({"telemetry": {"dir": "run"}}, False),
    ({"telemetry": {}}, False), ({"telemetry": False}, False),
    ({"telemetry": {"enabled": True, "dir": "run"}}, True),
    ({"resilience": {}}, False), ({"resilience": 0}, False),
    ({"resilience": {"enabled": True}}, False),
    ({"resilience": {"fault_injection": {"serve_decode_fault_at_step": 1}}},
     True)])
def test_init_serving_top_level_blocks_as_the_reference(config, on):
    """``init_serving``'s top-level blocks, read as the reference's
    ``init_serving`` reads them: telemetry is on with ``enabled: true``
    and parses to the reference's ``TelemetryConfig`` fields; resilience
    acts only through a ``fault_injection`` plan (serving chaos), which
    the port hands back for ``FaultPlan.resolve``."""
    import dataclasses

    from deepspeed_tpu.config.config import TelemetryConfig
    from deepspeed_tpu_torch.config import TelemetryConfig as PortTelemetry
    from deepspeed_tpu_torch.config.config import check_serving_blocks

    fault = dict(config.get("resilience") or {}).get("fault_injection")
    want = TelemetryConfig.from_dict(config.get("telemetry"))
    assert (want.enabled or bool(fault)) == on
    got = PortTelemetry.from_dict(config.get("telemetry"))
    assert got.enabled == want.enabled
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert check_serving_blocks(config) == (fault or None)
