"""Configurations: the paper's Table-1 CapsNet benchmarks
(``caps_benchmarks``, a copy of the JAX package's) and the LM registry
(``base``); importing this package registers the ported architectures."""
from repro_torch.configs import base
from repro_torch.configs.base import (SHAPES, SUBQUADRATIC, ShapeCell,
                                      cell_is_runnable, get_config,
                                      get_smoke_config, input_specs,
                                      list_archs, with_layers)
from repro_torch.configs import (falcon_mamba_7b,  # noqa: F401
                                  granite_3_2b, llava_next_mistral_7b,
                                  mistral_large_123b, mixtral_8x7b,
                                  phi3_medium_14b, qwen3_moe_30b_a3b,
                                  seamless_m4t_large_v2, stablelm_12b,
                                  zamba2_7b)

__all__ = ["SHAPES", "SUBQUADRATIC", "ShapeCell", "base", "cell_is_runnable",
           "get_config", "get_smoke_config", "input_specs", "list_archs",
           "with_layers"]
