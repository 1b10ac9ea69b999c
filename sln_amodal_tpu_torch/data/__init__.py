from . import semdist  # noqa: F401
from .dataset import AmodalCoco, AmodalDataset, DetectionResults  # noqa: F401
