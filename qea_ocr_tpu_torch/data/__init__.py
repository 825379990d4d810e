"""The port's data layer: the synthetic word and document worlds, collation
and the character map (numpy only, the port's own copies of the JAX
package's host modules), plus the device transfers in `pipeline`."""

from qea_ocr_tpu_torch.data.datasets import PatchDocuments
from qea_ocr_tpu_torch.data.pipeline import (
    DocBatch, DocTensors, WordBatch, WordTensors, batch_iterator,
    blank_docbatch, blank_wordbatch, collate_docs, collate_words,
    default_num_workers, doc_batch_to, pad_docbatch, pad_wordbatch,
    word_batch_to)
from qea_ocr_tpu_torch.utils.charmap import CharMap

__all__ = ["CharMap", "DocBatch", "DocTensors", "PatchDocuments",
           "WordBatch", "WordTensors", "batch_iterator", "blank_docbatch",
           "blank_wordbatch", "collate_docs", "collate_words",
           "default_num_workers", "doc_batch_to", "pad_docbatch",
           "pad_wordbatch", "word_batch_to"]
