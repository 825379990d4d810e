"""Query-budget selection: rank functions, `select_batch`, the global
selectors and the reference-shaped sampler classes."""

from qea_ocr_tpu_torch.selection.samplers import (  # noqa: F401
    ALL_METHODS,
    GLOBAL_METHODS,
    RANK_KERNELS,
    is_global,
    membership_mask,
    select_batch,
    select_global_random,
    select_global_uniform,
)
from qea_ocr_tpu_torch.selection.api import (  # noqa: F401
    CerRangeSampler,
    DataSampler,
    RandomSampler,
    RandomSamplerGlobal,
    TopKCERSampler,
    UniformEntropySampler,
    UniformSamplerGlobal,
    datasampler_factory,
)
