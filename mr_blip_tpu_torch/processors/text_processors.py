"""Text processors (caption/question pre-tokenization cleanup; the port's
copy of ``mr_blip_tpu/processors/text_processors.py``).

Mirror the reference ``BlipCaptionProcessor`` / ``BlipQuestionProcessor``
(lavis/processors/blip_processors.py:73-130): lowercase, strip punctuation
variants, cap word count.
"""

from __future__ import annotations

import re

from mr_blip_tpu_torch.common.registry import registry


class BaseProcessor:
    def __call__(self, item):
        return item

    @classmethod
    def from_config(cls, cfg=None):
        return cls()


@registry.register_processor("blip_caption")
class BlipCaptionProcessor(BaseProcessor):
    def __init__(self, prompt: str = "", max_words: int = 50):
        self.prompt = prompt
        self.max_words = max_words

    def __call__(self, caption: str) -> str:
        return self.prompt + self.pre_caption(caption)

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        return cls(
            prompt=cfg.get("prompt", ""), max_words=cfg.get("max_words", 50)
        )

    def pre_caption(self, caption: str) -> str:
        caption = re.sub(r"([.!\"()*#:;~])", " ", caption.lower())
        caption = re.sub(r"\s{2,}", " ", caption)
        caption = caption.rstrip("\n").strip(" ")
        words = caption.split(" ")
        if len(words) > self.max_words:
            caption = " ".join(words[: self.max_words])
        return caption


@registry.register_processor("blip_question")
class BlipQuestionProcessor(BaseProcessor):
    def __init__(self, max_words: int = 50):
        self.max_words = max_words

    def __call__(self, question: str) -> str:
        return self.pre_question(question)

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        return cls(max_words=cfg.get("max_words", 50))

    def pre_question(self, question: str) -> str:
        question = re.sub(r"([.!\"()*#:;~])", "", question.lower())
        question = question.rstrip(" ")
        words = question.split(" ")
        if len(words) > self.max_words:
            question = " ".join(words[: self.max_words])
        return question
