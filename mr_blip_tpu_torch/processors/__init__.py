"""Video and text processors (numpy, host side). Importing this package
registers ``blip_video_eval``, ``blip2_video_train`` and ``blip_question``."""

from mr_blip_tpu_torch.processors.text_processors import BlipQuestionProcessor
from mr_blip_tpu_torch.processors.video_processors import (
    Blip2VideoTrainProcessor,
    BlipVideoEvalProcessor,
    load_video,
)

__all__ = [
    "Blip2VideoTrainProcessor",
    "BlipVideoEvalProcessor",
    "BlipQuestionProcessor",
    "load_video",
]
