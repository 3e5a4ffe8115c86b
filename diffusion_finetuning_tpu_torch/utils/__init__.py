from .cli import Fire  # noqa: F401
