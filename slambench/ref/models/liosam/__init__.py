from .pipeline import LioSam  # noqa: F401
from .params import LioParams  # noqa: F401
