"""The port's data layer: the JAX package's numpy-only host modules
(the synthetic document world, collation, the character map), re-exported
so port code and scripts import data from one place, plus the device
transfer in `pipeline`."""

from qea_ocr_tpu.data.datasets import PatchDocuments
from qea_ocr_tpu.data.pipeline import collate_docs
from qea_ocr_tpu.utils.charmap import CharMap
from qea_ocr_tpu_torch.data.pipeline import DocTensors, doc_batch_to

__all__ = ["CharMap", "DocTensors", "PatchDocuments", "collate_docs",
           "doc_batch_to"]
