"""The port's data layer: the synthetic document world, collation and the
character map (numpy only, the port's own copies of the JAX package's host
modules), plus the device transfer in `pipeline`."""

from qea_ocr_tpu_torch.data.datasets import PatchDocuments
from qea_ocr_tpu_torch.data.pipeline import (
    DocBatch, DocTensors, batch_iterator, blank_docbatch, collate_docs,
    default_num_workers, doc_batch_to, pad_docbatch)
from qea_ocr_tpu_torch.utils.charmap import CharMap

__all__ = ["CharMap", "DocBatch", "DocTensors", "PatchDocuments",
           "batch_iterator", "blank_docbatch", "collate_docs",
           "default_num_workers", "doc_batch_to", "pad_docbatch"]
