from vpt_tpu_torch.actions.buttons import Buttons, SyntheticButtons
from vpt_tpu_torch.actions.quantizer import CameraQuantizer, QuantizationScheme
from vpt_tpu_torch.actions.transformer import ActionTransformer
from vpt_tpu_torch.actions.mapping import (
    ActionMapping,
    CameraHierarchicalMapping,
    IDMActionMapping,
)

__all__ = [
    "Buttons",
    "SyntheticButtons",
    "CameraQuantizer",
    "QuantizationScheme",
    "ActionTransformer",
    "ActionMapping",
    "CameraHierarchicalMapping",
    "IDMActionMapping",
]
