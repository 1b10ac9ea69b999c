from . import rle  # noqa: F401
from .amodal_eval import AmodalEval, Params, evaluate_sweep, print_stats  # noqa: F401
from .coco_results import build_coco_results  # noqa: F401
