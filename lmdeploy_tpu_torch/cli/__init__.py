from .entrypoint import main  # noqa: F401
