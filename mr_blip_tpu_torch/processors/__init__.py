"""Video, image and text processors (numpy, host side). Importing this
package registers ``blip_video_eval``, ``blip2_video_train``,
``blip_question``, ``blip_caption`` and the image processors
(``blip_image_train``/``_eval``, ``blip2_image_train``,
``clip_image_train``/``_eval``)."""

from mr_blip_tpu_torch.processors import image_processors  # noqa: F401  (registry)
from mr_blip_tpu_torch.processors.text_processors import (
    BlipCaptionProcessor,
    BlipQuestionProcessor,
)
from mr_blip_tpu_torch.processors.video_processors import (
    Blip2VideoTrainProcessor,
    BlipVideoEvalProcessor,
    load_video,
)

__all__ = [
    "Blip2VideoTrainProcessor",
    "BlipVideoEvalProcessor",
    "BlipCaptionProcessor",
    "BlipQuestionProcessor",
    "load_video",
]
