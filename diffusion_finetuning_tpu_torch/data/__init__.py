from .dataset import (  # noqa: F401
    OBJECT_TEMPLATE,
    STYLE_TEMPLATE,
    DataLoader,
    DreamBoothDataset,
    DreamBoothTiDataset,
    PivotalTuningDatasetCapation,
    PromptDataset,
    collate_batch,
)
from .tokenizer import CLIPTokenizer

__all__ = ["CLIPTokenizer", "DataLoader", "DreamBoothDataset", "DreamBoothTiDataset",
           "OBJECT_TEMPLATE", "PivotalTuningDatasetCapation", "PromptDataset",
           "STYLE_TEMPLATE", "collate_batch"]
