"""The module that computes a SMILES trunk of a given config.

`of(cfg)` is models/transformer.py for a `TransformerConfig` (COATI's
rotary trunk) and models/mla_moe.py for an `MlaMoeConfig` (DeepSeek-V2's
latent attention and experts). Both modules have `forward_hidden`,
`prefill`, `decode_step`, `decode_step_at`, `make_empty_cache` and
`decode_tables` with the same arguments, so the COATI API, the sampler and
the decode graph call the trunk through this one choice.
"""

from __future__ import annotations

from coati_tpu_torch.models import mla_moe, transformer


def of(cfg):
    """The trunk module for `cfg` (a TransformerConfig or an MlaMoeConfig)."""
    return mla_moe if isinstance(cfg, mla_moe.MlaMoeConfig) else transformer


def publish_counters(params) -> None:
    """Move a trunk's counters on the card to the tracer: the expert
    layers' (mla_moe.publish_counters); nothing for a trunk without them.
    Called where a call's results go to the host."""
    if isinstance(params, mla_moe.MlaMoeTransformer):
        mla_moe.publish_counters(params)
