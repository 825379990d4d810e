"""Label history and the loss weights over it."""

from qea_ocr_tpu_torch.tracking.history import LabelHistory  # noqa: F401
from qea_ocr_tpu_torch.tracking.weights import (  # noqa: F401
    attention_weights,
    decaying_weights,
    levenshtein_weights,
    weightgenerator_factory,
)
