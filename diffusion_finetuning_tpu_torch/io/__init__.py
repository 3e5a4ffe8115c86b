"""File formats: safetensors (``safetensors_io``); ``.pt`` files are
``torch.save`` / ``torch.load(weights_only=True)``."""

from . import safetensors_io  # noqa: F401
