from .mesh import DataParallel  # noqa: F401
