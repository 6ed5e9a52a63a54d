"""Elastic training (counterpart of ``deepspeed_tpu/elasticity/``;
reference: deepspeed/elasticity/)."""

from deepspeed_tpu_torch.elasticity.elasticity import (
    ElasticityConfig,
    ElasticityConfigError,
    ElasticityError,
    ElasticityIncompatibleWorldSize,
    compute_elastic_config,
    elasticity_enabled,
    ensure_immutable_elastic_config,
)

__all__ = [
    "ElasticityConfig", "ElasticityConfigError", "ElasticityError",
    "ElasticityIncompatibleWorldSize", "compute_elastic_config",
    "elasticity_enabled", "ensure_immutable_elastic_config",
]
